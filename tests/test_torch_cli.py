"""The port's command-line entry points, on the CPU at tiny widths.

``cli.serve.main`` on PNG folders writes exactly what ``load_engine`` +
``run`` give on the same arrays and seed (the last batch padded);
``cli.infer.main`` writes exactly what the Predictor from the same
checkpoint predicts. The checkpoints and base folder are written by the
port's own writers from a seeded tree.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from helpers import make_tokenizer_files
from instantrestore_tpu_torch.cli import infer, serve
from instantrestore_tpu_torch.convert import state_dict
from instantrestore_tpu_torch.data.transforms import denormalize_pm1
from instantrestore_tpu_torch.inference.predictor import Predictor
from instantrestore_tpu_torch.models import text_encoder as tte
from instantrestore_tpu_torch.models.lora import strip_lora
from instantrestore_tpu_torch.models.restorer import (
    init_restorer_params,
    original_unet_view,
    original_vae_view,
)
from instantrestore_tpu_torch.ops.primitives import _map_int8_convs
from instantrestore_tpu_torch.training.checkpoints import BASE_WEIGHTS_ENV, TOKENIZER_DIR_ENV
from instantrestore_tpu_torch.utils import safetensors
from instantrestore_tpu_torch.utils.torch_convert import (
    export_full_checkpoint,
    export_lora_only_checkpoint,
)

from test_torch_cold import T_STATICS

RES = 128


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny models: their many small ops then
    never wait on a thread team that other test workers crowd out."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A FULL and a LoRA-only checkpoint and a base folder, from one seeded
    tree whose trained conv_in differs from the base one."""
    root = tmp_path_factory.mktemp("cli")
    vocab = make_tokenizer_files(root / "base" / "tokenizer")
    gen = torch.Generator().manual_seed(0)
    params = init_restorer_params(gen, T_STATICS, lora_rank_unet=4, lora_rank_vae=4)
    params["unet"]["conv_in"] = {k: v + 0.05 for k, v in params["unet"]["conv_in"].items()}
    text = tte.init_text_encoder_params(gen, tte.CLIPTextConfig(
        vocab_size=len(vocab), hidden_size=16, num_layers=2, num_heads=1, intermediate_size=32))
    nets = {"unet": params["unet"], "vae": params["vae"],
            "original_unet": original_unet_view(params), "original_vae": original_vae_view(params),
            "text_encoder": text}
    export_full_checkpoint(nets, root / "full.pt",
                           cfg={"model": {"use_adain": True, "train_input": False}})
    export_lora_only_checkpoint(params, root / "lora.pt", rank_unet=4, rank_vae=4)
    for name, tree in (("unet", original_unet_view(params)), ("vae", strip_lora(params["vae"])),
                       ("text_encoder", text)):
        (root / "base" / name).mkdir()
        safetensors.save_file(state_dict(tree), root / "base" / name / "model.safetensors")
    return root


def write_dataset(root, rng):
    """alice: degraded.png and degraded/ (3 images, 4 references); bob: one
    image, 4 references; carol: 2 references, nothing to restore. Returns the
    arrays the serve CLI should read: refs [3, 4, RES, RES, 3], images, slots,
    and the output names."""
    def png(path, arr):
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(arr).save(path)
        return arr

    def img():
        return rng.integers(0, 256, (RES, RES, 3), dtype=np.uint8)

    refs, images, slots, names = [], [], [], []
    for slot, (name, n_refs, degraded) in enumerate(
            (("alice", 4, ["degraded.png", "degraded/x1.png", "degraded/x2.png"]),
             ("bob", 4, ["degraded.png"]), ("carol", 2, []))):
        given = [png(root / name / "conditioning" / f"{i}.png", img()) for i in range(n_refs)]
        refs.append(np.stack([given[i % n_refs][:, ::-1] if i >= n_refs else given[i]
                              for i in range(4)]))
        for rel in degraded:
            images.append(png(root / name / rel, img()))
            slots.append(slot)
            names.append(name if rel == "degraded.png" else f"{name}_{rel[9:-4]}")
    return np.stack(refs), np.stack(images), slots, names


def test_serve_main_equals_load_engine_and_run(files, tmp_path, rng):
    refs, images, slots, names = write_dataset(tmp_path / "data", rng)
    argv = ["--checkpoint", str(files / "lora.pt"), "--data_root", str(tmp_path / "data"),
            "--results_dir", str(tmp_path / "out"), "--base_weights_dir", str(files / "base"),
            "--batch", "3", "--seed", "5", "--device", "cpu"]
    assert serve.main(argv, statics=T_STATICS) == 0
    assert sorted(p.stem for p in (tmp_path / "out").iterdir()) == sorted(names)
    engine = serve.load_engine(files / "lora.pt", statics=T_STATICS,
                               base_weights_dir=str(files / "base"), device="cpu")
    assert engine.statics.unet_lora_scaling == 2.0 and engine.resolution == RES
    out = serve.run(engine, refs, images, slots, batch=3, seed=5).numpy()
    assert out.shape == (4, RES, RES, 3)
    for name, arr in zip(names, out):
        want = (denormalize_pm1(arr) * 255).clip(0, 255).astype(np.uint8)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "out" / f"{name}.png")),
                                      want, err_msg=name)


def test_serve_refusals(files, tmp_path):
    """A folder with nothing to restore is refused, by the int8 engine too
    (``--int8`` raised NotImplementedError before int8 serving was ported)."""
    argv = ["--checkpoint", str(files / "lora.pt"), "--data_root", str(tmp_path),
            "--device", "cpu", "--base_weights_dir", str(files / "base")]
    assert serve.main(argv + ["--int8"], statics=T_STATICS) == 1
    assert serve.main(argv, statics=T_STATICS) == 1


@pytest.mark.parametrize("calibrate", [True, False])
def test_serve_main_int8(files, tmp_path, rng, capsys, calibrate):
    """``--int8`` writes what an int8 ``load_engine`` + ``run`` give, its
    static scales calibrated on the first batch unless ``--no_calibrate``."""
    refs, images, slots, names = write_dataset(tmp_path / "data", rng)
    argv = ["--checkpoint", str(files / "lora.pt"), "--data_root", str(tmp_path / "data"),
            "--results_dir", str(tmp_path / "out"), "--base_weights_dir", str(files / "base"),
            "--batch", "3", "--seed", "5", "--device", "cpu", "--int8"]
    assert serve.main(argv + ([] if calibrate else ["--no_calibrate"]), statics=T_STATICS) == 0
    assert ("# calibrated" in capsys.readouterr().err) == calibrate
    engine = serve.load_engine(files / "lora.pt", statics=T_STATICS,
                               base_weights_dir=str(files / "base"), device="cpu", int8=True)
    out = serve.run(engine, refs, images, slots, batch=3, seed=5, calibrate=calibrate).numpy()
    convs = _int8_convs(engine.params)
    assert convs and sum("a_scale" in p for p in convs) == (len(convs) if calibrate else 0)
    for name, arr in zip(names, out):
        want = (denormalize_pm1(arr) * 255).clip(0, 255).astype(np.uint8)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "out" / f"{name}.png")),
                                      want, err_msg=name)


def _int8_convs(tree):
    convs = []
    _map_int8_convs(tree, lambda p: convs.append(p) or p)
    return convs


@pytest.mark.parametrize("schema", ["full", "lora"])
def test_infer_main_writes_what_the_predictor_predicts(files, tmp_path, rng, monkeypatch, schema):
    """The FULL file finds its tokenizer, the LoRA-only one its base folder,
    through the environment, as scripts/infer.py's do."""
    write_dataset(tmp_path / "data", rng)
    monkeypatch.setenv(TOKENIZER_DIR_ENV, str(files / "base" / "tokenizer"))
    monkeypatch.setenv(BASE_WEIGHTS_ENV, str(files / "base"))
    ckpt = str(files / f"{schema}.pt")
    assert infer.main(["--checkpoint", ckpt, "--data_root", str(tmp_path / "data"),
                       "--results_dir", str(tmp_path / "out"), "--device", "cpu"],
                      statics=T_STATICS) == 0
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["alice.png", "bob.png"]
    pred = Predictor(ckpt, statics=T_STATICS, device="cpu")
    for name in ("alice", "bob"):
        d = tmp_path / "data" / name
        conds = [Image.open(p).convert("RGB") for p in sorted((d / "conditioning").glob("*"))]
        want, _ = pred.predict(Image.open(d / "degraded.png").convert("RGB"), conds)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "out" / f"{name}.png")),
                                      np.asarray(want), err_msg=name)
