"""Port primitives, FreeU, LoRA merge and scheduler vs the JAX package.

Same numpy inputs through both; fp32 on the CPU. Tolerance: 1e-5 relative
(plus 1e-5 absolute for values near zero) — the two differ only in the
order of fp32 sums inside convolutions and reductions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.models import freeu as jfreeu
from instantrestore_tpu.models import lora as jlora
from instantrestore_tpu.models import scheduler as jsched
from instantrestore_tpu.ops import primitives as jprim
from instantrestore_tpu_torch.convert import from_jax_tree
from instantrestore_tpu_torch.models import freeu as tfreeu
from instantrestore_tpu_torch.models import lora as tlora
from instantrestore_tpu_torch.models import scheduler as tsched
from instantrestore_tpu_torch.ops import primitives as tprim

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _with_lora(p, rng, rank=3):
    """Attach LoRA factors with a nonzero B (peft's zero init would hide a
    layout error)."""
    p = dict(p)
    w = p["kernel"]
    if w.ndim == 4:
        kh, kw, cin, cout = w.shape
        p["lora_A"] = jnp.asarray(rng.normal(size=(kh, kw, cin, rank)), jnp.float32)
        p["lora_B"] = jnp.asarray(rng.normal(size=(1, 1, rank, cout)), jnp.float32)
    else:
        cin, cout = w.shape
        p["lora_A"] = jnp.asarray(rng.normal(size=(cin, rank)), jnp.float32)
        p["lora_B"] = jnp.asarray(rng.normal(size=(rank, cout)), jnp.float32)
    return p


@pytest.mark.parametrize("stride,padding,lora,ksize", [
    (1, 1, False, 3), (1, 1, True, 3), (2, 1, True, 3), (2, 0, False, 3), (1, 0, True, 1),
])
def test_conv2d_matches_jax(rng, stride, padding, lora, ksize):
    p = jprim.init_conv2d(jax.random.PRNGKey(0), 5, 7, ksize)
    p["bias"] = jnp.asarray(rng.normal(size=7), jnp.float32)
    if lora:
        p = _with_lora(p, rng)
    x = rng.normal(size=(2, 9, 10, 5)).astype(np.float32)
    ref = jprim.conv2d(p, jnp.asarray(x), stride=stride, padding=padding, lora_scaling=0.5)
    out = tprim.conv2d(from_jax_tree(p), _t(x), stride=stride, padding=padding, lora_scaling=0.5)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("lora", [False, True])
def test_dense_and_geglu_match_jax(rng, lora):
    p = jprim.init_dense(jax.random.PRNGKey(1), 12, 16)
    p["bias"] = jnp.asarray(rng.normal(size=16), jnp.float32)
    if lora:
        p = _with_lora(p, rng)
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    tp = from_jax_tree(p)
    np.testing.assert_allclose(
        tprim.dense(tp, _t(x), lora_scaling=0.5).numpy(),
        _np(jprim.dense(p, jnp.asarray(x), lora_scaling=0.5)), **TOL)
    np.testing.assert_allclose(
        tprim.geglu(tp, _t(x), lora_scaling=0.5).numpy(),
        _np(jprim.geglu(p, jnp.asarray(x), lora_scaling=0.5)), **TOL)


def test_norms_match_jax(rng):
    x = rng.normal(size=(2, 6, 5, 8)).astype(np.float32) * 3 + 1
    p = {"scale": jnp.asarray(rng.normal(size=8), jnp.float32),
         "bias": jnp.asarray(rng.normal(size=8), jnp.float32)}
    tp = from_jax_tree(p)
    np.testing.assert_allclose(
        tprim.group_norm(tp, _t(x), num_groups=4, eps=1e-6).numpy(),
        _np(jprim.group_norm(p, jnp.asarray(x), num_groups=4, eps=1e-6)), **TOL)
    np.testing.assert_allclose(
        tprim.layer_norm(tp, _t(x)).numpy(), _np(jprim.layer_norm(p, jnp.asarray(x))), **TOL)


def test_upsample2x_conv_matches_jax(rng):
    p = jprim.init_conv2d(jax.random.PRNGKey(2), 6, 4, 3)
    p["bias"] = jnp.asarray(rng.normal(size=4), jnp.float32)
    x = rng.normal(size=(2, 5, 4, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tprim.nearest_upsample_2x(_t(x)).numpy(), _np(jprim.nearest_upsample_2x(jnp.asarray(x))))
    np.testing.assert_allclose(
        tprim.upsample2x_conv(from_jax_tree(p), _t(x)).numpy(),
        _np(jprim.upsample2x_conv(p, jnp.asarray(x))), **TOL)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 249, 999], np.int32)
    for dim, shift in ((320, 0.0), (32, 1.0)):
        ref = jprim.timestep_embedding(jnp.asarray(t), dim, downscale_freq_shift=shift)
        out = tprim.timestep_embedding(torch.from_numpy(t), dim, downscale_freq_shift=shift)
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("idx,hw", [(0, (8, 8)), (1, (6, 10)), (2, (4, 4)), (1, (5, 7))])
def test_freeu_matches_jax(rng, idx, hw):
    hid = rng.normal(size=(2, *hw, 6)).astype(np.float32)
    skip = rng.normal(size=(2, *hw, 4)).astype(np.float32)
    jh, js = jfreeu.apply_freeu(idx, jnp.asarray(hid), jnp.asarray(skip), jfreeu.FreeUParams())
    th, ts = tfreeu.apply_freeu(idx, _t(hid), _t(skip), tfreeu.FreeUParams())
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)


def test_merge_and_strip_lora_match_jax(rng):
    tree = {"conv1": _with_lora(jprim.init_conv2d(jax.random.PRNGKey(3), 4, 6, 3), rng),
            "proj": _with_lora(jprim.init_dense(jax.random.PRNGKey(4), 5, 7), rng),
            "norm": jprim.init_norm(6)}
    merged = tlora.merge_lora(from_jax_tree(tree), 0.25)
    ref = from_jax_tree(jlora.merge_lora(tree, 0.25))
    for name in ("conv1", "proj"):
        assert set(merged[name]) == {"weight", "bias"}
        np.testing.assert_allclose(merged[name]["weight"].numpy(), ref[name]["weight"].numpy(), **TOL)
    stripped = tlora.strip_lora(from_jax_tree(tree))
    assert "lora_A" not in stripped["conv1"] and "lora_B" not in stripped["proj"]


def test_scheduler_matches_jax(rng):
    abar_j = jsched.make_alphas_cumprod()
    abar_t = tsched.make_alphas_cumprod()
    np.testing.assert_array_equal(abar_t.numpy(), _np(abar_j))
    x = rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
    n = rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
    t = np.array([1, 249, 999], np.int32)
    zt_j = jsched.add_noise(abar_j, jnp.asarray(x), jnp.asarray(n), jnp.asarray(t))
    zt_t = tsched.add_noise(abar_t, _t(x), _t(n), torch.from_numpy(t).long())
    np.testing.assert_allclose(zt_t.numpy(), _np(zt_j), **TOL)
    x0_j = jsched.pred_original_sample(abar_j, jnp.asarray(n), zt_j, jnp.asarray(t))
    x0_t = tsched.pred_original_sample(abar_t, _t(n), zt_t, torch.from_numpy(t).long())
    np.testing.assert_allclose(x0_t.numpy(), _np(x0_j), rtol=1e-5, atol=1e-4)


def test_freeu_single_pixel_follows_diffusers():
    """At a 1x1 skip diffusers' fourier_filter scales the one bin once, so
    the skip becomes scale * skip. The JAX package's 4-bin projection counts
    that bin four times there (its f=0 and f=-1 basis vectors coincide);
    the port keeps the diffusers result. Only sub-2x2 skips differ, which
    no 512 px restore has (its smallest FreeU skip is 8x8)."""
    skip = torch.randn(2, 1, 1, 5)
    _, out = tfreeu.apply_freeu(0, torch.zeros(2, 1, 1, 4), skip, tfreeu.FreeUParams(s1=0.9))
    torch.testing.assert_close(out, 0.9 * skip)


def test_group_norm_bf16_matches_jax_memory_light_path(rng):
    """bf16 takes the JAX package's memory-light branch (fp32 mean and
    mean-square, one x * a + b pass in bf16): same up to bf16 rounding. JAX
    rounds x * a and + b separately, the port once, so allow two bf16 ulps:
    1e-2 relative plus 1e-2 absolute."""
    x = (rng.normal(size=(2, 6, 5, 16)) * 3 + 1).astype(np.float32)
    p = {"scale": jnp.asarray(rng.normal(size=16), jnp.float32),
         "bias": jnp.asarray(rng.normal(size=16), jnp.float32)}
    ref = jprim.group_norm(p, jnp.asarray(x, jnp.bfloat16), num_groups=4, eps=1e-6)
    out = tprim.group_norm(from_jax_tree(p), _t(x).bfloat16(), num_groups=4, eps=1e-6)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
