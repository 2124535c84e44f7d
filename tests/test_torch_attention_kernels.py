"""The port's kernel modules vs the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels are held against those same plain versions on the card by
chip_smoke.py); the JAX side runs its Pallas kernels in interpret mode, as
its own tests do. fp32, tolerance 2e-5 absolute: the two differ only in fp32
summation order (the bound softmax itself is the same formula).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.ops import shared_attention as jsa
from instantrestore_tpu_torch.ops import _build
from instantrestore_tpu_torch.ops import shared_attention as tsa

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.fixture(autouse=True)
def no_kernel_build(monkeypatch):
    """CPU tensors must never reach the CUDA build."""
    def refuse(name):
        raise AssertionError(f"CPU path tried to load kernel {name}")
    monkeypatch.setattr(_build, "load", refuse)
    tsa.reset_launch_counts()
    yield
    assert tsa.flash_attention.launches == 0
    assert tsa.shared_attention_identity.launches == 0


@pytest.mark.parametrize("b,h,s,skv,d", [
    (2, 3, 64, 64, 16), (2, 2, 64, 128, 64), (1, 1, 32, 32, 512),
])
def test_flash_bound_matches_pallas(rng, b, h, s, skv, d):
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k = rng.normal(size=(b, h, skv, d)).astype(np.float32)
    v = rng.normal(size=(b, h, skv, d)).astype(np.float32)
    scale = d ** -0.5
    ref = jsa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
                              interpret=True, algo="bound")
    out = tsa.flash_attention(_t(q), _t(k), _t(v), scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tsa.flash_attention_plain(_t(q), _t(k), _t(v), scale=scale).numpy(),
                               np.asarray(ref), **TOL)


def test_flash_plain_matches_softmax(rng):
    """The bound formula is softmax attention, up to rounding."""
    q, k, v = (_t(rng.normal(size=(2, 2, 32, 16))) for _ in range(3))
    ref = torch.softmax(q @ k.transpose(-1, -2) * 0.25, dim=-1) @ v
    np.testing.assert_allclose(tsa.flash_attention_plain(q, k, v, scale=0.25).numpy(),
                               ref.numpy(), **TOL)


def _identity_inputs(rng, n=4, i_ident=4, b=3, h=2, s=32, d=16):
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k_in = rng.normal(size=(b, h, s, d)).astype(np.float32)
    v_in = (rng.normal(size=(b, h, s, d)) * 2 + 0.5).astype(np.float32)
    rk = rng.normal(size=(i_ident, n, h, s, d)).astype(np.float32)
    rv = (rng.normal(size=(i_ident, n, h, s, d)) * 0.7 - 0.3).astype(np.float32)
    return q, k_in, v_in, rk, rv


@pytest.mark.parametrize("use_adain", [True, False])
@pytest.mark.parametrize("ids", [[2, 0, 2], [3, 3, 1]])
def test_identity_attention_matches_pallas(rng, use_adain, ids):
    """Port (raw cache) vs the TPU's paired identity kernel (block-diagonal
    cache) built from the same numpy K/V; ids repeat and skip identities."""
    q, k_in, v_in, rk, rv = _identity_inputs(rng)
    scale = q.shape[-1] ** -0.5
    (jcache,) = jsa.build_identity_kv_cache([(jnp.asarray(rk), jnp.asarray(rv))], block_k=16)
    assert jcache.paired
    ref = jsa.shared_attention_identity(
        jnp.asarray(q), jnp.asarray(k_in), jnp.asarray(v_in), jcache,
        jnp.asarray(ids, jnp.int32), scale=scale, use_adain=use_adain, block_q=16,
        interpret=True,
    )
    (tcache,) = tsa.build_identity_kv_cache([(_t(rk), _t(rv))])
    out = tsa.shared_attention_identity(_t(q), _t(k_in), _t(v_in), tcache, torch.tensor(ids),
                                        scale=scale, use_adain=use_adain)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_identity_cache_stats_match_jax(rng):
    _, _, v_in, rk, rv = _identity_inputs(rng, n=3)
    (jcache,) = jsa.build_identity_kv_cache([(jnp.asarray(rk), jnp.asarray(rv))], pack_pairs=False)
    (tcache,) = tsa.build_identity_kv_cache([(_t(rk), _t(rv))])
    for name in ("content_mean", "content_std", "kmax"):
        np.testing.assert_allclose(getattr(tcache, name).numpy(),
                                   np.asarray(getattr(jcache, name)), **TOL)
    ids = np.array([1, 2, 1])
    js, jh = jsa.adain_affine_from_stats(jnp.asarray(v_in), jcache.content_mean[ids],
                                         jcache.content_std[ids])
    ts, th = tsa.adain_affine_from_stats(_t(v_in), tcache.content_mean[ids],
                                         tcache.content_std[ids])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_identity_odd_refs_and_zeroed_segment(rng):
    """Odd N (the TPU's unpaired kernel) and a zeroed reference (an invalid
    ref keeps its uniform attention mass): same function in the port."""
    q, k_in, v_in, rk, rv = _identity_inputs(rng, n=3)
    rk[1, 2] = 0.0
    rv[1, 2] = 0.0
    scale = q.shape[-1] ** -0.5
    ids = [1, 0, 1]
    (jcache,) = jsa.build_identity_kv_cache([(jnp.asarray(rk), jnp.asarray(rv))], block_k=16)
    assert not jcache.paired
    ref = jsa.shared_attention_identity(
        jnp.asarray(q), jnp.asarray(k_in), jnp.asarray(v_in), jcache,
        jnp.asarray(ids, jnp.int32), scale=scale, use_adain=True, block_q=16, interpret=True,
    )
    (tcache,) = tsa.build_identity_kv_cache([(_t(rk), _t(rv))])
    out = tsa.shared_attention_identity(_t(q), _t(k_in), _t(v_in), tcache, torch.tensor(ids),
                                        scale=scale, use_adain=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_wrappers_reject_other_devices():
    q = torch.zeros((1, 1, 64, 64), device="meta")
    with pytest.raises(ValueError):
        tsa.flash_attention(q, q, q, scale=0.125)
