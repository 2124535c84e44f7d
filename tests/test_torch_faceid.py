"""FaceID conditioning (``condition_on_face_embeds``): face embeddings of the
references replace the prompt as the restoration UNet's cross-attention
context, through each ``attn2``'s FaceID projections. The port vs the JAX
package at tiny widths, fp32, on the CPU: ``restore_forward(face_embeds=)``
and ``Predictor.predict(face_embeds=)``, and the provider's embeddings with
their zero fallback (``tests/test_faceid.py``'s cases). JAX's noise is
redrawn with its own helpers (``jax_draws``) and injected.

Tolerances: 1e-3 max-abs on output images (as ``tests/test_torch_cold.py``),
1 uint8 level on the Predictor's images (as ``tests/test_torch_predictor.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from instantrestore_tpu.inference import predictor as jpred
from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.inference import predictor as tpred
from instantrestore_tpu_torch.models import lora as tlora
from instantrestore_tpu_torch.models import restorer as trest

from test_torch_cold import B, N, RES, jax_draws, statics_pair
from test_torch_serving import random_tree

# the cold tests' tiny widths with one layer a block, to keep JAX's compiles short
J_FACE, T_FACE = (
    dataclasses.replace(s, unet_cfg=dataclasses.replace(s.unet_cfg, layers_per_block=1),
                        vae_cfg=dataclasses.replace(s.vae_cfg, layers_per_block=1))
    for s in statics_pair(use_adain=True, train_input=False, condition_on_face_embeds=True))
M = 4  # embeddings a sample: the Predictor's four references


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, more threads only
    contend (as ``tests/test_torch_coach.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    params = random_tree(
        lambda k: jrest.init_restorer_params(k, J_FACE, lora_rank_unet=4, lora_rank_vae=4),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(8)
    return dict(jax=params, torch=convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, params)),
                images=rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32),
                conds=rng.uniform(-1, 1, (B, N, RES, RES, 3)).astype(np.float32),
                embeds=rng.normal(size=(B, M, 512)).astype(np.float32))


def test_restore_forward_with_face_embeds_matches_jax(models):
    """The serving bundle conditioned on face embeddings restores as JAX's;
    other embeddings, or none (the prompt), give another output."""
    key = jax.random.PRNGKey(6)
    fwd = jax.jit(lambda p, x, c, e, r: jrest.restore_forward(
        p, x, c, rng=r, face_embeds=e, statics=J_FACE, timestep=249)["output_image"])
    ref = np.asarray(fwd(jrest.serving_bundle(models["jax"], J_FACE), models["images"],
                         models["conds"], models["embeds"], key))
    bundle = trest.serving_bundle(models["torch"], T_FACE)
    x, c = torch.from_numpy(models["images"]), torch.from_numpy(models["conds"])
    noise = jax_draws(key, B, N)

    def port(embeds):
        with torch.no_grad():
            return trest.restore_forward(bundle, x, c, statics=T_FACE, noise=noise,
                                         face_embeds=embeds)["output_image"]

    out = port(torch.from_numpy(models["embeds"]))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3)
    assert float((port(torch.from_numpy(-models["embeds"])) - out).abs().max()) > 1e-3
    assert float((port(None) - out).abs().max()) > 1e-3


def test_faceid_leaves_are_not_trained():
    """As in the JAX package, the Coach's mask trains LoRA and conv_in, not
    the FaceID projections (ROADMAP "Known quirks")."""
    p = trest.init_restorer_params(torch.Generator().manual_seed(0), T_FACE, lora_rank_unet=2,
                                   lora_rank_vae=2)
    mask = tlora.trainable_mask(p["unet"], extra_trainable=("conv_in",))
    attn2 = mask["up_blocks"][1]["attentions"][0]["transformer_blocks"][0]["attn2"]
    assert attn2["face_projection"] == {"weight": False, "bias": False}
    assert attn2["to_k_face_embed"] == attn2["to_v_face_embed"] == {"weight": False}
    assert attn2["to_q"]["lora_A"] and not attn2["to_q"]["weight"]


def _pil(rng, w, h):
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def stub_provider(image):
    """A face embedder stand-in: a unit vector from the image's pixels, None
    (no face found) for a dark image."""
    a = np.asarray(image, np.float32)
    if a.mean() < 64:
        return None
    v = np.resize(a.reshape(-1)[:4096], 512)
    return v / np.linalg.norm(v)


@pytest.fixture(scope="module")
def predictors(models):
    jp = jpred.Predictor(params=models["jax"], statics=J_FACE, dtype=jnp.float32, resolution=RES,
                         deterministic=True, seed=3, face_embed_provider=stub_provider)
    tp = tpred.Predictor(params=models["torch"], statics=T_FACE, dtype=torch.float32,
                         resolution=RES, deterministic=True, seed=3, device="cpu",
                         face_embed_provider=stub_provider)
    return jp, tp


def test_predict_with_face_embeds_matches_jax_predictor(predictors):
    """Given embeddings, and the provider's of the references by default,
    restore as JAX's Predictor does; the embeddings condition the output."""
    jp, tp = predictors
    rng = np.random.default_rng(4)
    img, conds = _pil(rng, 150, 170), [_pil(rng, 130, 140) for _ in range(3)]
    noise = jax_draws(jax.random.PRNGKey(3), 1, 4, sample_posterior=False)
    e = rng.normal(size=(M, 512)).astype(np.float32)
    ref, _ = jp.predict(img, conds, face_embeds=e)
    out, _ = tp.predict(img, conds, face_embeds=e, noise=noise)
    np.testing.assert_allclose(np.asarray(out, np.int16), np.asarray(ref, np.int16),
                               rtol=0, atol=1)
    ref_p, _ = jp.predict(img, conds)
    out_p, _ = tp.predict(img, conds, noise=noise)
    np.testing.assert_allclose(np.asarray(out_p, np.int16), np.asarray(ref_p, np.int16),
                               rtol=0, atol=1)
    assert np.abs(np.asarray(out_p, np.int16) - np.asarray(out, np.int16)).max() > 0


def test_provider_embeds_and_zero_fallback(predictors):
    """The provider's embeddings as JAX's: zeros where it finds no face, the
    given references repeated up to four, all zeros without references; a
    FaceID model without embeddings or a provider raises."""
    jp, tp = predictors
    rng = np.random.default_rng(5)
    dark = Image.fromarray(np.full((64, 64, 3), 10, np.uint8))
    for refs in ([_pil(rng, 80, 80), dark], [dark], [_pil(rng, 90, 70)] * 5, []):
        got, want = tp.compute_face_embeds(refs), jp.compute_face_embeds(refs)
        assert got.shape == (4, 512)
        np.testing.assert_array_equal(got, want)
    assert not tp.compute_face_embeds([dark]).any() and not tp.compute_face_embeds([]).any()
    bare = tpred.Predictor(params=tp.params, statics=T_FACE, dtype=torch.float32,
                           resolution=RES, device="cpu")
    with pytest.raises(ValueError, match="face_embed"):
        bare.predict(_pil(rng, 64, 64), [_pil(rng, 64, 64)])
