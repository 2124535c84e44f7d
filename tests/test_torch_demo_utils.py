"""The port's demo and small utilities against the JAX package, on the CPU:
``inference/demo.py`` through ``tests/test_demo.py``'s flow (the model
selector over two FULL checkpoints, an identity fixture, the restore with
its per-reference attention mass) and ``degrade_image`` bit for bit;
``data/mask_utils.py`` bit for bit on the same numpy inputs and draws;
``utils/profiling.py`` and ``utils/git_utils.py``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from helpers import make_tokenizer_files
from instantrestore_tpu.data import mask_utils as jmu
from instantrestore_tpu.inference import demo as jdemo
from instantrestore_tpu.models.unet import UNetConfig
from instantrestore_tpu.models.vae import VAEConfig
from instantrestore_tpu.utils import git_utils as jgit
from instantrestore_tpu_torch.data import mask_utils as tmu
from instantrestore_tpu_torch.inference import demo as tdemo
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.models import text_encoder as tte
from instantrestore_tpu_torch.models import unet as tunet
from instantrestore_tpu_torch.models import vae as tvae
from instantrestore_tpu_torch.utils import git_utils as tgit
from instantrestore_tpu_torch.utils import profiling
from instantrestore_tpu_torch.utils.torch_convert import export_full_checkpoint

UCFG = UNetConfig(sample_size=8, block_out_channels=(32, 64, 64, 64), attention_heads=(1, 2, 2, 2),
                  cross_attention_dim=16, norm_num_groups=8)
VCFG = VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4)
T_STATICS = trest.RestorerStatics(unet_cfg=tunet.UNetConfig(**UCFG.__dict__),
                                  vae_cfg=tvae.VAEConfig(**VCFG.__dict__),
                                  compute_dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (as ``tests/test_torch_serving.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """tests/test_demo.py's fixtures: two FULL checkpoints (written by the
    port's own writer from seeded trees), an identity and tokenizer files."""
    tok = tmp_path_factory.mktemp("tok")
    vocab = make_tokenizer_files(tok)
    cfg = tte.CLIPTextConfig(vocab_size=len(vocab), hidden_size=16, num_layers=2, num_heads=1,
                             intermediate_size=32, max_position_embeddings=77,
                             eos_token_id=len(vocab) - 1)
    ckpt_dir = tmp_path_factory.mktemp("ckpt")
    models = {}
    for i, name in enumerate(["Base Model", "Final Model"]):
        gen = torch.Generator().manual_seed(i)
        params = trest.init_restorer_params(gen, T_STATICS, lora_rank_unet=4, lora_rank_vae=4)
        nets = {"unet": params["unet"], "vae": params["vae"],
                "original_unet": trest.original_unet_view(params),
                "original_vae": trest.original_vae_view(params),
                "text_encoder": tte.init_text_encoder_params(gen, cfg)}
        models[name] = str(ckpt_dir / f"model{i}.pt")
        export_full_checkpoint(nets, models[name], cfg={"model": {"use_adain": False}})
    rng = np.random.default_rng(11)
    root = tmp_path_factory.mktemp("data")
    d = root / "carol"
    (d / "conditioning").mkdir(parents=True)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(
            d / "conditioning" / f"{i}.png")
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(d / "degraded.png")
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(d / "gt.png")
    return models, str(tok), str(root)


def test_demo_run_and_model_switch(env):
    models, tok, root = env
    demo = tdemo.Demo(root, models=models, predictor_kwargs=dict(
        statics=T_STATICS, resolution=64, dtype=torch.float32, tokenizer_dir=tok, device="cpu"))
    assert demo.identities == ["carol"]
    data = demo.load_identity("carol")
    assert len(data["conditioning"]) == 3 and data["gt"].size == (64, 64)
    pred, attn = demo.run("Base Model", "carol")
    assert pred.size == (64, 64)
    assert len(attn) == 4 and all(0.0 <= v <= 100.0 for v in attn)  # refs pad to 4
    assert abs(sum(attn) - 100.0) < 1e-3
    first = demo._predictor
    pred2, _ = demo.run("Final Model", "carol")
    assert demo._predictor is not first
    assert np.abs(np.asarray(pred, np.float32) - np.asarray(pred2, np.float32)).max() > 1.0
    second = demo._predictor
    demo.run("Final Model", "carol")  # the same model: the predictor is kept
    assert demo._predictor is second


def test_demo_without_gradio_raises_jax_message(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(RuntimeError, match="gradio is not installed in this environment"):
        tdemo.Demo(str(tmp_path)).launch_gradio()


@pytest.mark.parametrize("level", [0, 37, 100])
def test_degrade_image_matches_jax(level):
    clean = Image.fromarray(np.random.default_rng(0).integers(0, 255, (600, 560, 3), np.uint8))
    got = np.asarray(tdemo.degrade_image(clean, level, seed=3))
    assert got.shape == (512, 512, 3)
    np.testing.assert_array_equal(got, np.asarray(jdemo.degrade_image(clean, level, seed=3)))


# ---------------------------------------------------------------------------
# mask_utils
# ---------------------------------------------------------------------------


def _disk(res=64, r=18):
    yy, xx = np.mgrid[:res, :res]
    return ((yy - res // 2) ** 2 + (xx - res // 2) ** 2) <= r * r


def _same(a, b):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


MASK_CASES = {
    "compute_outward_normals": lambda mu, rng: mu.compute_outward_normals(
        np.stack([32 + 10 * np.cos(t := np.linspace(0, 2 * np.pi, 64, endpoint=False)),
                  32 + 10 * np.sin(t)], axis=1)),
    "generate_smooth_shifts": lambda mu, rng: mu.generate_smooth_shifts(256, -5, 5, 15, rng),
    "generate_smooth_shifts (short)": lambda mu, rng: mu.generate_smooth_shifts(3, -5, 5, 7, rng),
    "shift_points_smoothly": lambda mu, rng: mu.shift_points_smoothly(
        np.array([[0.0, 0.0], [63.0, 0.0], [63.0, 63.0], [0.0, 63.0]]), (64, 64), 0.2, 0.3,
        rng=rng),
    "get_vertices": lambda mu, rng: mu.get_vertices(_disk()),
    "get_augmented_mask": lambda mu, rng: mu.get_augmented_mask(_disk(), -0.06, 0.06, 5, rng),
    "get_augmented_mask (empty)": lambda mu, rng: mu.get_augmented_mask(np.zeros((8, 8))),
    "recolor_enclosed_regions": lambda mu, rng: mu.recolor_enclosed_regions(
        np.pad(np.pad(np.zeros((10, 10), np.uint8), 15, constant_values=1), 10)),
    "draw_landmarks_on_image": lambda mu, rng: mu.draw_landmarks_on_image(
        np.zeros((128, 128, 3), np.uint8), [(256.0, 256.0), (100.0, 300.0)], reference_size=512),
}


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_mask_utils_match_jax(case):
    fn = MASK_CASES[case]
    _same(fn(tmu, np.random.default_rng(1)), fn(jmu, np.random.default_rng(1)))


def test_mask_utils_import_without_opencv():
    import subprocess
    import sys

    code = ("import sys; sys.modules['cv2'] = None; "
            "from instantrestore_tpu_torch.data import mask_utils as m; import numpy as np; "
            "m.generate_smooth_shifts(8, -1, 1, 3, np.random.default_rng(0))")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=Path(__file__).resolve().parent.parent)


# ---------------------------------------------------------------------------
# profiling and git_utils
# ---------------------------------------------------------------------------


def test_nameit_prints_and_returns(capsys):
    @profiling.nameit
    def twice(x):
        return 2 * x

    assert twice(4) == 8
    out = capsys.readouterr().out
    assert "twice] took" in out and out.startswith("[")


def test_stage_times_and_names_profiler_ranges(monkeypatch):
    monkeypatch.setattr(profiling, "_STAGE_TIMES", {})
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with profiling.stage("encode"):
                torch.ones(4).sum()
    report = profiling.stage_report()
    assert report["encode"]["count"] == 2 and report["encode"]["mean_s"] >= 0
    assert any(e.name == "encode" for e in prof.events())


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t"), host=True):
        with profiling.stage("step"):
            torch.ones(8).cumsum(0)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "step" for e in events)


def test_git_info_matches_jax(tmp_path):
    info = tgit.get_git_info()
    assert info == jgit.get_git_info()
    assert set(info) == {"commit", "branch", "dirty"} and info["dirty"] in ("yes", "no")
    tgit.dump_git_info(tmp_path / "exp")
    jgit.dump_git_info(tmp_path / "jexp")
    assert (tmp_path / "exp" / "git_info.txt").read_text() == \
        (tmp_path / "jexp" / "git_info.txt").read_text()


def test_git_info_without_git(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert tgit.get_git_info() == {"commit": "", "branch": "", "dirty": "no"}
