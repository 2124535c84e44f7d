"""``python -m instantrestore_tpu_torch.cli.evaluate`` against
``scripts/evaluate.py`` on the same folders (on the CPU): the printed line,
the report's keys and each image's PSNR, SSIM and, with weights, LPIPS;
the ID cosine against JAX's ArcFace on the same resize; an empty folder
refused. Tolerance: 1e-5 relative with 1e-6 absolute (fp32 metrics of the
same images summed in another order; PSNR's log of a mean of squares).
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from instantrestore_tpu.training.losses import id_loss as jid
from instantrestore_tpu.training.losses import lpips as jlp
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.cli import evaluate

from test_torch_serving import random_tree

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (as ``tests/test_torch_serving.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_evaluate():
    spec = importlib.util.spec_from_file_location("evaluate_cli", REPO / "scripts" / "evaluate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def dirs(tmp_path):
    """tests/test_evaluate_cli.py's folders: an exact copy, two noisy
    predictions, an unmatched one."""
    rng = np.random.default_rng(3)
    pred, gt = tmp_path / "pred", tmp_path / "gt"
    pred.mkdir()
    gt.mkdir()
    for i in range(3):
        img = rng.integers(0, 255, (64, 64, 3), np.uint8)
        Image.fromarray(img).save(gt / f"im{i}.png")
        if i:
            img = np.clip(img.astype(np.int32) + rng.integers(-40, 40, img.shape), 0,
                          255).astype(np.uint8)
        Image.fromarray(img).save(pred / f"im{i}.png")
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(pred / "orphan.png")
    return pred, gt


@pytest.fixture()
def lpips_weights(tmp_path):
    rng = np.random.default_rng(0)
    vgg_sd, in_ch = {}, 3
    for (out_ch, _), ids in zip(jlp.VGG_STAGES, jlp._TV_CONV_IDX):
        for ci in ids:
            vgg_sd[f"features.{ci}.weight"] = torch.from_numpy(
                rng.normal(size=(out_ch, in_ch, 3, 3)).astype(np.float32) * 0.05)
            vgg_sd[f"features.{ci}.bias"] = torch.zeros(out_ch)
            in_ch = out_ch
    lin_sd = {f"lin{i}.model.1.weight": torch.from_numpy(
        np.abs(rng.normal(size=(1, c, 1, 1))).astype(np.float32))
        for i, c in enumerate(jlp.LIN_CHANNELS)}
    vgg_p, lin_p = tmp_path / "vgg16.pth", tmp_path / "lin.pth"
    torch.save(vgg_sd, str(vgg_p))
    torch.save(lin_sd, str(lin_p))
    return ["--lpips_vgg", str(vgg_p), "--lpips_lin", str(lin_p)]


def _both(dirs, tmp_path, capsys, extra=()):
    pred, gt = dirs
    argv = ["--pred_dir", str(pred), "--gt_dir", str(gt), "--resolution", "64", "--batch", "2",
            *extra]
    assert _jax_evaluate().main(argv + ["--out", str(tmp_path / "jax.json")]) == 0
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    assert evaluate.main(argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    return (json.loads((tmp_path / "jax.json").read_text()),
            json.loads((tmp_path / "port.json").read_text()), json.loads(jline), json.loads(tline))


def _close(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v
        else:
            np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL, err_msg=k)


def test_evaluate_matches_jax_without_weights(dirs, tmp_path, capsys):
    jrep, trep, jline, tline = _both(dirs, tmp_path, capsys)
    _close(tline, jline)
    assert trep.keys() == jrep.keys() and trep["weights"] == jrep["weights"]
    assert trep["weights"] == {"lpips": "absent", "arcface": "absent"}
    assert trep["n_images"] == jrep["n_images"] == 3
    for got, want in zip(trep["per_image"], jrep["per_image"]):
        _close(got, want)
    _close(trep["aggregate"], jrep["aggregate"])
    rows = {r["image"]: r for r in trep["per_image"]}
    assert rows["im0.png"]["psnr"] > 50 and rows["im0.png"]["ssim"] > 0.99
    assert "lpips" not in rows["im0.png"] and "id_cosine" not in rows["im0.png"]


def test_evaluate_matches_jax_with_lpips_weights(dirs, tmp_path, capsys, lpips_weights):
    jrep, trep, jline, tline = _both(dirs, tmp_path, capsys, lpips_weights)
    _close(tline, jline)
    assert trep["weights"] == jrep["weights"] == {"lpips": "converted", "arcface": "absent"}
    for got, want in zip(trep["per_image"], jrep["per_image"]):
        _close(got, want)
    rows = {r["image"]: r for r in trep["per_image"]}
    assert rows["im0.png"]["lpips"] < 1e-6 and rows["im1.png"]["lpips"] > 0


def test_evaluate_empty(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    assert evaluate.main(["--pred_dir", str(tmp_path / "a"), "--gt_dir", str(tmp_path / "b"),
                          "--device", "cpu"]) == 1


def test_id_cosine_matches_jax_arcface():
    """The ID row: both images resized to 112 (antialiased linear, as
    ``jax.image.resize``) through IR-SE-50, the cosine of the embeddings."""
    jtree = random_tree(jid.init_arcface_params, jax.random.PRNGKey(0))
    ttree = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, jtree))
    rng = np.random.default_rng(1)
    pred = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.2, pred.shape), -1, 1).astype(np.float32)
    got = evaluate.metrics_batch(torch.from_numpy(pred), torch.from_numpy(gt),
                                 arcface_params=ttree)["id_cosine"].numpy()
    both = jax.image.resize(jnp.concatenate([pred, gt]), (4, 112, 112, 3), "linear",
                            antialias=True)
    e = np.asarray(jax.jit(jid.arcface_apply)(jtree, both))
    np.testing.assert_allclose(got, (e[:2] * e[2:]).sum(-1), rtol=1e-4, atol=1e-5)
