"""``python -m instantrestore_tpu_torch.cli.parity`` (the counterpart of
``scripts/parity.py``) on the CPU at the cold tests' tiny widths (one layer
a block), 128 px.

``dump-activations`` writes JAX's keys, and its taps hold against JAX's
``restore_forward(debug_taps=True)`` in fp32 on the same weights with JAX's
noise injected (every tap within 1e-4 + 1e-3 of its max |value|);
``convert-diff`` reports a reference-schema ``.pt`` (the checkpoint tests'
writer) and exits 1 under ``--strict`` once a key is removed;
``determinism`` reports two equal predictions and a dump whose noise
reproduces them; ``gradio`` runs over a two-identity fixture folder.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from helpers import make_tokenizer_files
from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.cli import parity
from instantrestore_tpu_torch.inference.predictor import Predictor
from instantrestore_tpu_torch.utils import torch_convert as ttc

from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.models import unet as tunet
from instantrestore_tpu_torch.models import vae as tvae

from test_torch_checkpoints import jax_text_tree, one_thread, write_full_pt  # noqa: F401
from test_torch_cold import N, RES, UCFG, VCFG, jax_draws
from test_torch_serving import random_tree

TAP_ATOL, TAP_RTOL = 1e-4, 1e-3  # of each tap's max |value|, fp32 against fp32
# the cold tests' widths with one layer a block (the JAX jit of the dump's
# forward is most of this file's time)
UCFG1, VCFG1 = (dataclasses.replace(c, layers_per_block=1) for c in (UCFG, VCFG))
J_STATICS = jrest.RestorerStatics(unet_cfg=UCFG1, vae_cfg=VCFG1, compute_dtype=jnp.float32,
                                  use_adain=True, train_input=False)
T_STATICS = trest.RestorerStatics(unet_cfg=tunet.UNetConfig(**UCFG1.__dict__),
                                  vae_cfg=tvae.VAEConfig(**VCFG1.__dict__),
                                  compute_dtype=torch.float32, use_adain=True, train_input=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A FULL reference .pt of tiny widths, its tokenizer, an input image,
    two references and a two-identity gradio folder."""
    root = tmp_path_factory.mktemp("parity")
    vocab = make_tokenizer_files(root / "tokenizer")
    params = random_tree(lambda k: jrest.init_restorer_params(k, J_STATICS, lora_rank_unet=4,
                                                              lora_rank_vae=4),
                         jax.random.PRNGKey(0))
    write_full_pt(root / "model.pt", params, jax_text_tree(len(vocab)))
    rng = np.random.default_rng(3)

    def png(path, side=RES + 16):
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (side, side, 3), np.uint8)).save(path)

    png(root / "input.png")
    for i in range(N):
        png(root / "refs" / f"r{i}.png")
    for ident in ("ann", "ben"):
        for name in ("degraded.png", "gt.png", "conditioning/c0.png", "conditioning/c1.png"):
            png(root / "gradio" / ident / name)
    return dict(root=root, params=params, pt=str(root / "model.pt"))


def predictor_args(files, *more):
    return ["--checkpoint", files["pt"], "--tokenizer_dir", str(files["root"] / "tokenizer"),
            "--resolution", str(RES), "--device", "cpu", *more]


def test_dump_activations_keys_are_jax_and_values_match(files, tmp_path):
    """The CLI's dump has JAX's keys: JAX's taps plus output_image,
    input_image and conds. The dump's function on the same weights in fp32,
    with JAX's noise for PRNGKey(seed): every tap matches JAX's."""
    out, npz = tmp_path / "r.json", tmp_path / "act.npz"
    assert parity.main(["dump-activations", *predictor_args(files, "--fp32"), "--input",
                        str(files["root"] / "input.png"), "--refs", str(files["root"] / "refs"),
                        "--dump", str(npz), "--out", str(out)], statics=T_STATICS) == 0
    report = json.loads(out.read_text())
    dumped = dict(np.load(npz))
    assert sorted(dumped) == report["stages"] and report["seconds"] > 0

    pred = Predictor(params=convert.from_jax_tree(files["params"]), statics=T_STATICS,
                     dtype=torch.float32, resolution=RES, deterministic=True, device="cpu")
    image = pred.prepare_image(Image.open(files["root"] / "input.png").convert("RGB"), RES)[None]
    conds, _ = pred.prepare_conditioning_images(
        [Image.open(p).convert("RGB") for p in sorted((files["root"] / "refs").glob("*"))],
        resolution=RES)
    key = jax.random.PRNGKey(0)
    taps = parity.dump_activations(pred, image, conds,
                                   noise=jax_draws(key, 1, conds.shape[0], sample_posterior=False))
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float32)),
                                     files["params"])
    jout = jax.jit(lambda p, im, cd, v, r: jrest.restore_forward(
        p, im, cd, v, rng=r, statics=J_STATICS, timestep=249, sample_posterior=False,
        debug_taps=True, use_fused_attention=False))(
        jparams, jnp.asarray(image), jnp.asarray(conds)[None],
        jnp.full((1,), conds.shape[0], jnp.int32), key)
    want = {k: np.asarray(v, np.float32) for k, v in jout["taps"].items()}
    want["output_image"] = np.asarray(jout["output_image"], np.float32)
    want["input_image"], want["conds"] = image, conds
    assert sorted(taps) == sorted(want) == sorted(dumped)
    for k, w in want.items():
        assert taps[k].shape == w.shape, k
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(taps[k], w, rtol=0, atol=TAP_ATOL + TAP_RTOL * scale,
                                   err_msg=k)


def test_convert_diff_reports_and_strict_fails_on_a_removed_key(files, tmp_path):
    out = tmp_path / "r.json"
    args = ["convert-diff", "--pt", files["pt"], "--strict", "--out", str(out)]
    assert parity.main(args + ["--no-template"], statics=T_STATICS) == 0
    report = json.loads(out.read_text())
    assert report["ok"] and set(report["groups"]) == set(ttc.NETWORKS)
    for net, g in report["groups"].items():
        # the text encoder's position_ids buffer counts on the file's side only, as in JAX's
        assert (g["abs_mass_rel_err"] < 1e-12) == (net != "text_encoder") and g["strict"]["ok"]
        assert not g["strict"]["unmapped_keys"] and g["strict"]["roundtrip_maxabs"] == 0.0
        assert {"torch_key", "shape", "mean", "std", "absmax", "finite"} <= set(g["tensors"][0])
    # against the template at the model's widths the whole file is there ...
    assert parity.main(args, statics=T_STATICS) == 0
    # ... and a removed key is a missing leaf
    raw = torch.load(files["pt"], weights_only=True)
    gone = next(k for k in raw["state_dict"] if k.startswith("net.unet.") and "lora_B" in k)
    del raw["state_dict"][gone]
    cut = tmp_path / "cut.pt"
    torch.save(raw, str(cut))
    args[2] = str(cut)
    assert parity.main(args, statics=T_STATICS) == 1
    report = json.loads(out.read_text())
    assert report["failed_groups"] == ["unet"]
    assert len(report["groups"]["unet"]["strict"]["missing_template_leaves"]) == 1


def test_determinism_reports_equal_predictions_and_its_noise(files, tmp_path):
    out, npz = tmp_path / "r.json", tmp_path / "dump.npz"
    assert parity.main(["determinism", *predictor_args(files), "--input",
                        str(files["root"] / "input.png"), "--refs", str(files["root"] / "refs"),
                        "--dump", str(npz), "--out", str(out)], statics=T_STATICS) == 0
    report = json.loads(out.read_text())
    assert report["deterministic"] and report["repeat_maxabs_uint8"] == 0.0
    assert report["dump_noise_reproduces_output"]
    dump = np.load(npz)
    assert sorted(dump) == ["conds", "image", "noise", "noise_cond_diffusion", "output",
                            "timestep"]
    assert dump["noise"].shape == (1, RES // 8, RES // 8, 4) and int(dump["timestep"]) == 249


def test_gradio_runs_over_two_identities(files, tmp_path):
    out = tmp_path / "r.json"
    assert parity.main(["gradio", *predictor_args(files), "--data",
                        str(files["root"] / "gradio"), "--out", str(out)],
                       statics=T_STATICS) == 0
    report = json.loads(out.read_text())
    assert report["arcface_weights"] == "random" and report["n_identities"] == 2
    for row in report["per_identity"]:
        assert np.isfinite([row["psnr_vs_gt"], row["l2_vs_gt"], row["id_cosine_vs_gt"],
                            row["id_cosine_vs_refs"]]).all()
        assert len(row["attention_pct"]) == 4 and abs(sum(row["attention_pct"]) - 100) < 1e-6
    assert set(report["aggregate"]) == {"psnr_vs_gt", "id_cosine_vs_gt", "id_cosine_vs_refs"}
