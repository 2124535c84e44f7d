"""The port's Predictor and inference transforms vs the JAX package's, at
tiny widths in fp32 on the CPU.

The JAX Predictor (deterministic) draws its noise from PRNGKey(seed); the
test redraws it with the JAX restorer's own helpers and injects it into the
port's Predictor. Tolerance: 1 uint8 level on the output image (the float
outputs agree to 1e-3, and truncation to uint8 can flip a level), 2e-3 on the
attention percentages (rounded to 3 decimals by both).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from instantrestore_tpu.data import transforms as jtr
from instantrestore_tpu.inference import predictor as jpred
from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.data import transforms as ttr
from instantrestore_tpu_torch.inference import predictor as tpred
from instantrestore_tpu_torch.models import restorer as trest

from test_torch_cold import J_STATICS, T_STATICS, jax_draws
from test_torch_serving import random_tree

RES = 128


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, more threads only
    contend (as ``tests/test_torch_coach.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pil(rng, w, h):
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def test_infer_transform_matches_jax(rng):
    for w, h in ((150, 200), (300, 130), (128, 128)):
        img = _pil(rng, w, h)
        np.testing.assert_array_equal(ttr.infer_transform(img, RES), jtr.infer_transform(img, RES))
    x = rng.uniform(-1.5, 1.5, (4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttr.denormalize_pm1(x), jtr.denormalize_pm1(x))


@pytest.mark.parametrize("train_input", [False, True])
def test_attention_mass_percentages_match_jax(rng, train_input):
    n_refs, sq = 4, 16
    probs = [rng.uniform(0, 1, (1, 2, sq, sq * (n_refs + train_input))).astype(np.float32)
             for _ in range(3)]
    ref = jpred.attention_mass_percentages([jnp.asarray(p) for p in probs], n_refs, train_input)
    out = tpred.attention_mass_percentages([torch.from_numpy(p) for p in probs], n_refs,
                                           train_input)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-3)
    assert abs(sum(out) - 100) < 1e-6


@pytest.fixture(scope="module")
def predictors():
    params = random_tree(
        lambda k: jrest.init_restorer_params(k, J_STATICS, lora_rank_unet=4, lora_rank_vae=4),
        jax.random.PRNGKey(0))
    tparams = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, params))
    jp = jpred.Predictor(params=params, statics=J_STATICS, dtype=jnp.float32, resolution=RES,
                         deterministic=True, seed=3)
    tp = tpred.Predictor(params=tparams, statics=T_STATICS, dtype=torch.float32, resolution=RES,
                         deterministic=True, seed=3, device="cpu")
    return jp, tp


@pytest.mark.parametrize("n_given", [1, 3])
def test_prepare_conditioning_images_match_jax(predictors, rng, n_given):
    """Missing references are padded by copies, every other one flipped."""
    jp, tp = predictors
    imgs = [_pil(rng, 140, 160) for _ in range(n_given)]
    ref, jn = jp.prepare_conditioning_images(imgs, resolution=RES)
    out, tn = tp.prepare_conditioning_images(imgs, resolution=RES)
    assert out.shape == (4, RES, RES, 3) and tn == jn == n_given
    np.testing.assert_array_equal(out, ref)


def test_predict_matches_jax_predictor(predictors, rng):
    """predict on PIL images, deterministic, with and without the attention
    percentages (the unfused probability path and the fused path)."""
    jp, tp = predictors
    img, conds = _pil(rng, 150, 170), [_pil(rng, 130, 140) for _ in range(3)]
    ref_img, ref_attn = jp.predict(img, conds, return_attention=True)
    noise = jax_draws(jax.random.PRNGKey(3), 1, 4, sample_posterior=False)
    out_img, out_attn = tp.predict(img, conds, return_attention=True, noise=noise)
    assert out_img.size == ref_img.size == (RES, RES)
    np.testing.assert_allclose(np.asarray(out_img, np.int16), np.asarray(ref_img, np.int16),
                               rtol=0, atol=1)
    np.testing.assert_allclose(out_attn, ref_attn, rtol=0, atol=2e-3)
    tp._fused = True
    try:
        fused_img, none = tp.predict(img, conds, noise=noise)
    finally:
        tp._fused = False
    assert none is None
    np.testing.assert_allclose(np.asarray(fused_img, np.int16), np.asarray(ref_img, np.int16),
                               rtol=0, atol=1)


def test_predict_batch_and_determinism(predictors, rng):
    """Array in, array out; deterministic predicts reseed their noise."""
    _, tp = predictors
    images = rng.uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    conds = rng.uniform(-1, 1, (2, 4, RES, RES, 3)).astype(np.float32)
    out = tp.predict_batch(images, conds, valid=np.array([4, 2]))
    assert out.shape == (2, RES, RES, 3) and out.dtype == np.float32
    assert np.isfinite(out).all() and np.abs(out).max() <= 1.0
    img, refs = _pil(rng, RES, RES), [_pil(rng, RES, RES)]
    a, _ = tp.predict(img, refs)
    b, _ = tp.predict(img, refs)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_run_directory_writes_one_png_per_identity(predictors, rng, tmp_path):
    _, tp = predictors
    for name, with_degraded in (("alice", True), ("bob", True), ("empty", False)):
        d = tmp_path / "data" / name / "conditioning"
        d.mkdir(parents=True)
        _pil(rng, 140, 140).save(d / "0.png")
        if with_degraded:
            _pil(rng, 150, 130).save(d.parent / "degraded.png")
    tp.run_directory(str(tmp_path / "data"), str(tmp_path / "out"))
    written = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert written == ["alice.png", "bob.png"]
    assert Image.open(tmp_path / "out" / "alice.png").size == (RES, RES)


def test_missing_pieces_raise(predictors, monkeypatch, tmp_path):
    """A FaceID model with neither embeddings nor a provider raises rather
    than fall back to the prompt; a checkpoint that is not there, or
    neither weights nor a checkpoint, raise; without a card the default
    device raises rather than falling back to the CPU."""
    _, tp = predictors
    with pytest.raises(FileNotFoundError):
        tpred.Predictor(str(tmp_path / "model.pt"), device="cpu")
    with pytest.raises(ValueError, match="checkpoint_path or params"):
        tpred.Predictor(statics=T_STATICS, device="cpu")
    faceid = dataclasses.replace(T_STATICS, condition_on_face_embeds=True)
    fp = tpred.Predictor(params=tp.params, statics=faceid, device="cpu")
    with pytest.raises(ValueError, match="face_embeds"):
        fp.predict_batch(np.zeros((1, RES, RES, 3), np.float32),
                         np.zeros((1, 4, RES, RES, 3), np.float32))
    with pytest.raises(ValueError, match="face_embed_provider"):
        fp.compute_face_embeds([np.zeros((RES, RES, 3), np.uint8)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tpred.Predictor(params=tp.params, statics=T_STATICS)
