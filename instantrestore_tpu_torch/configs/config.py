"""Configuration tree for training and inference, decodable from YAML plus
dotted ``section.field=value`` overrides (the port's own copy of
``instantrestore_tpu/configs/config.py``: same fields, same defaults, so the
reference's YAML files decode unchanged).

Every loss weight of ``OptimConfig`` is acted on (``training/losses/
composite.py``). Fields of the JAX package's multi-device runs are kept so
that such files still load: ``mesh_shape`` is not read (one process, one
card). ``steps_per_dispatch`` above 1 runs that many G + D steps per
dispatch, each a replay of one captured CUDA graph (``training/coach.py``),
as JAX's scanned multi-step dispatch runs them in one compiled program.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Union


class SchedulerType(enum.Enum):
    COSINE = "cosine"
    STEP = "step"
    LINEAR = "linear"
    COSINE_WITH_RESTARTS = "cosine_with_restarts"
    POLYNOMIAL = "polynomial"
    CONSTANT = "constant"
    CONSTANT_WITH_WARMUP = "constant_with_warmup"


@dataclass
class ComputeConfig:
    batch_size: int = 3
    test_batch_size: Optional[int] = None
    workers: int = 12
    test_workers: Optional[int] = None
    seed: int = 42
    mesh_shape: Optional[List[int]] = None  # device mesh of the JAX package; unused here
    compute_dtype: str = "bfloat16"
    # fused attention kernels in the train and eval steps (ops/flash_vjp.py).
    # None = auto: on for a CUDA device, off on the CPU. Layers that must
    # return attention probabilities for a loss always take the unfused path.
    fused_attention: Optional[bool] = None
    # checkpoint each restore stage in the train step (encode, capture, UNet,
    # decode): activations are rebuilt in the backward. None = auto: on for a
    # CUDA device, off on the CPU.
    remat: Optional[bool] = None
    # G + D steps per dispatch (the JAX package's scanned loop; the port's
    # Coach replays a captured CUDA graph of the step that many times)
    steps_per_dispatch: int = 1

    def __post_init__(self):
        if self.test_batch_size is None:
            self.test_batch_size = self.batch_size
        if self.test_workers is None:
            self.test_workers = self.workers


@dataclass
class OptimConfig:
    optim_name: str = "adamW"
    learning_rate: float = 5e-4
    scheduler_type: SchedulerType = SchedulerType.COSINE
    target_lr: float = 5e-6
    use_clip_grad: bool = True
    clip_grad_max_norm: float = 1.0
    clip_grad_norm_type: float = 2
    weight_decay: float = 1e-2
    mixed_precision: bool = True
    gradient_accumulation_steps: int = 1
    gradient_checkpointing: bool = False
    gan_disc_type: str = "vagan_clip"
    gan_loss_type: str = "multilevel_sigmoid_s"
    lambda_gan: float = 0.5
    lambda_lpips: float = 5.0
    lambda_l2: float = 5.0
    lambda_l1: float = 0.0
    lambda_ssim: float = 0.0
    lambda_id_loss: float = 1.0
    lambda_attn_reg: float = 0.0
    lambda_clipsim: float = 0.0
    lambda_dreamsim: float = 0.0
    lambda_wavelets_loss: float = 0.0
    lambda_latent_loss: float = 0.0
    lambda_cycle: float = 0.0
    lambda_landmark: float = 0.0
    lambda_pos_reg: float = 0.0
    lambda_neg_reg: float = 0.0
    lambda_facial_comp: float = 0.0
    compute_id_loss_between_identities: bool = False
    # also run the MTCNN cascade on predictions at validation cadence and log
    # the detector-aligned ID similarity beside the dataset-aligned one
    id_detect_predictions: bool = False
    lr_warmup_steps: int = 100
    lr_num_cycles: int = 1
    lr_power: float = 1.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-08
    enable_xformers_memory_efficient_attention: bool = False  # accepted, unused


@dataclass
class DataConfig:
    dataset_type: str = "debug"
    data_root: Union[str, List[str]] = ""
    val_data_root: str = ""
    overfit: bool = False
    test_leakage: bool = True
    train_image_prep: str = "resized_crop_512"
    test_image_prep: str = "resized_crop_512"
    resolution: int = 512
    max_conditioning_images: int = 4
    augment_masks: bool = False
    store_landmarks: bool = False


@dataclass
class ModelConfig:
    net_type: str = "pix2pix_turbo"
    use_pretrained: bool = True
    lora_rank_unet: int = 16
    lora_rank_vae: int = 16
    condition_on_face_embeds: bool = False
    concat_mask_and_landmarks: bool = False
    use_shared_attention: bool = True
    noise_timestep: int = 249
    train_vae: bool = True
    train_only_vae_encoder: bool = False
    checkpoint_path: Optional[str] = None
    use_shortcuts: bool = False
    guidance_scale: float = 0.0
    train_reference_networks: bool = False
    use_adain: bool = False
    train_input: bool = True


@dataclass
class LogConfig:
    exp_root: str = "experiments"
    exp_name: str = "instantrestore_tpu"
    allow_overwrite: bool = True
    log2wandb: bool = True  # selects tensorboard, matching the reference
    val_vis_count: int = 50
    vis_attention: bool = True
    # resume a run from a full checkpoint directory (params, optimizer states,
    # step counter, best-validation tracker)
    resume_from: Optional[str] = None

    @property
    def exp_dir(self) -> Path:
        return Path(self.exp_root) / self.exp_name


@dataclass
class TrainStepsConfig:
    max_steps: int = 15_000
    image_interval: int = 150
    metric_interval: int = 10
    val_interval: int = 250
    save_interval: int = 100_000


@dataclass
class TrainConfig:
    compute: ComputeConfig = field(default_factory=ComputeConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    log: LogConfig = field(default_factory=LogConfig)
    steps: TrainStepsConfig = field(default_factory=TrainStepsConfig)


# ---------------------------------------------------------------------------
# pyrallis-like decoding: YAML file + --section.field=value CLI overrides
# ---------------------------------------------------------------------------


def _coerce(value: Any, ftype: Any) -> Any:
    import typing

    origin = typing.get_origin(ftype)
    if origin is Union:
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        if value is None:
            return None
        for a in args:
            try:
                return _coerce(value, a)
            except (TypeError, ValueError):
                continue
        return value
    if origin in (list, List):
        (sub,) = typing.get_args(ftype) or (str,)
        if isinstance(value, str):
            value = [v for v in value.split(",") if v]
        return [_coerce(v, sub) for v in value]
    if isinstance(ftype, type) and issubclass(ftype, enum.Enum):
        if isinstance(value, ftype):
            return value
        try:
            return ftype[str(value).upper()]
        except KeyError:
            return ftype(value)
    if ftype is bool:
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("1", "true", "yes", "on")
    if ftype in (int, float, str):
        return ftype(value)
    if ftype is Path:
        return Path(value)
    return value


def load_config(
    yaml_path: Optional[str] = None,
    overrides: Optional[List[str]] = None,
    cls=TrainConfig,
):
    """Build a config from YAML plus ``section.field=value`` overrides
    (yaml is imported only to read a file)."""
    data: Dict[str, Any] = {}
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
    for ov in overrides or []:
        ov = ov.lstrip("-")
        key, _, value = ov.partition("=")
        node = data
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return _decode_section(cls, data)


def _decode_section(cls, data: Dict[str, Any]):
    import typing

    hints = typing.get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for name, value in (data or {}).items():
        if name not in fields:
            raise ValueError(f"unknown config field {cls.__name__}.{name}")
        ftype = hints[name]
        if dataclasses.is_dataclass(ftype):
            kwargs[name] = _decode_section(ftype, value)
        else:
            kwargs[name] = _coerce(value, ftype)
    return cls(**kwargs)


def encode_config(cfg) -> Dict[str, Any]:
    """Config -> plain dict (for checkpoint round-tripping)."""

    def enc(v):
        if dataclasses.is_dataclass(v):
            return {f.name: enc(getattr(v, f.name)) for f in dataclasses.fields(v)}
        if isinstance(v, enum.Enum):
            return v.name
        if isinstance(v, Path):
            return str(v)
        if isinstance(v, list):
            return [enc(x) for x in v]
        return v

    return enc(cfg)
