"""The port's kernel modules vs the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels are held against those same plain versions on the card by
chip_smoke.py); the JAX side runs its Pallas kernels in interpret mode, as
its own tests do. fp32, tolerance 2e-5 absolute: the two differ only in fp32
summation order (the bound softmax itself is the same formula). The bf16
cases state their own tolerances.
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
    assert not any(fn.launches for fn in tsa.KERNEL_WRAPPERS)


@pytest.mark.parametrize("b,h,s,skv,d", [
    (2, 3, 64, 64, 16), (2, 2, 64, 128, 64), (1, 1, 32, 32, 512), (2, 1, 128, 128, 512),
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


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _bf16_err(out, ref):
    o, r = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    return np.abs(o - r).max(), np.abs(o - r).mean()


@pytest.mark.parametrize("use_adain", [True, False])
def test_identity_odd_refs_bf16_matches_pallas(rng, use_adain):
    """bf16, odd N: the port runs the TPU's unpaired bound kernel (rounded-p
    row sum, bound from the unscaled q norm, bf16 affine) as the JAX package
    does. Without AdaIN the two agree to the last bf16 bit but for a few
    elements (mean-abs <= 1e-5; the paired kernel's numerics give 1.6e-4 here);
    with AdaIN the port rounds v * a + c once where the TPU kernel rounds the
    product and the sum, within 1 bf16 ulp of the value (mean-abs <= 1e-3,
    max-abs <= 1.6e-2, about 2 ulps at the outputs' largest magnitude)."""
    q, k_in, v_in, rk, rv = _identity_inputs(rng, n=3, b=2, s=64, d=64)
    ids = [1, 3]
    (jcache,) = jsa.build_identity_kv_cache(
        [(jnp.asarray(rk, jnp.bfloat16), jnp.asarray(rv, jnp.bfloat16))], block_k=32)
    ref = jsa.shared_attention_identity(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k_in, jnp.bfloat16),
        jnp.asarray(v_in, jnp.bfloat16), jcache, jnp.asarray(ids, jnp.int32), scale=0.125,
        use_adain=use_adain, block_q=32, interpret=True)
    (tcache,) = tsa.build_identity_kv_cache([(_bf16(rk), _bf16(rv))])
    out = tsa.shared_attention_identity(_bf16(q), _bf16(k_in), _bf16(v_in), tcache,
                                        torch.tensor(ids), scale=0.125, use_adain=use_adain)
    max_abs, mean_abs = _bf16_err(out, ref)
    assert mean_abs <= (1e-3 if use_adain else 1e-5) and max_abs <= 1.6e-2, (max_abs, mean_abs)


def _shared_inputs(rng, n, b=2, h=2, s=32, d=16):
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k_in = rng.normal(size=(b, h, s, d)).astype(np.float32)
    v_in = (rng.normal(size=(b, h, s, d)) * 2 + 0.5).astype(np.float32)
    rk = rng.normal(size=(b, n, h, s, d)).astype(np.float32)
    rv = (rng.normal(size=(b, n, h, s, d)) * 0.7 - 0.3).astype(np.float32)
    rk[1, n - 1] = 0.0  # a masked (invalid) reference: zeroed, still attended
    rv[1, n - 1] = 0.0
    return q, k_in, v_in, rk, rv


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("use_adain", [True, False])
@pytest.mark.parametrize("include_input", [True, False])
def test_shared_flash_bound_matches_pallas(rng, n, use_adain, include_input):
    """Per-call shared attention (the TPU's _shared_kvouter_bound_kernel):
    the port's wrapper and its plain version vs the Pallas kernel, fp32."""
    q, k_in, v_in, rk, rv = _shared_inputs(rng, n)
    scale = q.shape[-1] ** -0.5
    jaff = jsa.adain_affine(jnp.asarray(v_in), jnp.asarray(rv)) if use_adain else None
    ref = jsa.shared_flash_attention(
        jnp.asarray(q), jnp.asarray(k_in), jnp.asarray(v_in), jnp.asarray(rk), jnp.asarray(rv),
        scale=scale, v_affine=jaff, include_input=include_input, algo="kv_outer_bound",
        block_q=16, block_k=16, interpret=True)
    taff = tsa.adain_affine(_t(v_in), _t(rv)) if use_adain else None
    out = tsa.shared_flash_attention(_t(q), _t(k_in), _t(v_in), _t(rk), _t(rv), scale=scale,
                                     v_affine=taff, include_input=include_input)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    b, h, _, d = q.shape
    kmax = tsa.key_norm_max(_t(rk), (1, 3))
    if include_input:
        kmax = torch.maximum(kmax, tsa.key_norm_max(_t(k_in), 2))
    plain = tsa.shared_flash_bound_plain(_t(q), _t(k_in), _t(v_in), _t(rk), _t(rv),
                                         tsa._affine(taff, b, h, n, d, "cpu"), kmax, scale=scale,
                                         include_input=include_input)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("include_input", [True, False])
def test_shared_flash_bound_bf16_matches_pallas(rng, include_input):
    """bf16 with the AdaIN affine, where the bf16 affine and the row sum over
    rounded p show: mean-abs <= 1e-3 and max-abs <= 1.6e-2 (about 2 bf16 ulps
    at the outputs' largest magnitude, ~1.8), the single vs double rounding of
    v * a + c being the difference."""
    q, k_in, v_in, rk, rv = _shared_inputs(rng, 3, s=64, d=64)
    j = [jnp.asarray(x, jnp.bfloat16) for x in (q, k_in, v_in, rk, rv)]
    ref = jsa.shared_flash_attention(*j, scale=0.125, v_affine=jsa.adain_affine(j[2], j[4]),
                                     include_input=include_input, algo="kv_outer_bound",
                                     block_q=32, block_k=32, interpret=True)
    t = [_bf16(x) for x in (q, k_in, v_in, rk, rv)]
    out = tsa.shared_flash_attention(*t, scale=0.125, v_affine=tsa.adain_affine(t[2], t[4]),
                                     include_input=include_input)
    assert out.dtype == torch.bfloat16
    max_abs, mean_abs = _bf16_err(out, ref)
    assert mean_abs <= 1e-3 and max_abs <= 1.6e-2, (max_abs, mean_abs)


@pytest.mark.parametrize("include_input", [False, True])
def test_paired_route_matches_pallas(rng, monkeypatch, include_input):
    """INSTANTRESTORE_ATTN_ALGO=kv_outer_bound_paired: refs-only calls with
    even N run the paired numerics (the identity kernel on the per-call K/V);
    calls with the input segment fall back to the bound kernel, as in JAX."""
    monkeypatch.setenv("INSTANTRESTORE_ATTN_ALGO", "kv_outer_bound_paired")
    q, k_in, v_in, rk, rv = _shared_inputs(rng, 4)
    scale = q.shape[-1] ** -0.5
    ref = jsa.shared_flash_attention(
        jnp.asarray(q), jnp.asarray(k_in), jnp.asarray(v_in), jnp.asarray(rk), jnp.asarray(rv),
        scale=scale, v_affine=jsa.adain_affine(jnp.asarray(v_in), jnp.asarray(rv)),
        include_input=include_input, block_q=16, block_k=16, interpret=True)
    calls = _record_plain_calls(monkeypatch)
    out = tsa.shared_flash_attention(_t(q), _t(k_in), _t(v_in), _t(rk), _t(rv), scale=scale,
                                     v_affine=tsa.adain_affine(_t(v_in), _t(rv)),
                                     include_input=include_input)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert calls == ["shared_flash_bound_plain" if include_input else "shared_identity_plain"]


def test_adain_affine_matches_jax(rng):
    _, _, v_in, _, rv = _shared_inputs(rng, 3)
    js, jh = jsa.adain_affine(jnp.asarray(v_in), jnp.asarray(rv))
    ts, th = tsa.adain_affine(_t(v_in), _t(rv))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def record_calls(monkeypatch, module, names):
    """Wrap ``module.<name>`` for each name; returns the list that collects
    the names as they are called."""
    calls = []
    for name in names:
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    return calls


def _record_plain_calls(monkeypatch):
    """Every plain version the port runs from here on, by name, in order."""
    return record_calls(monkeypatch, tsa, [n for n in dir(tsa) if n.endswith("_plain")])


@pytest.mark.parametrize("algo,heads,plain", [
    ("kv_outer", 2, ["shared_online_plain"]),
    ("q_outer", 2, ["shared_online_plain"]),
    ("kv_outer_packed", 2, ["shared_online_pair_plain", "shared_online_plain"]),
    ("kv_outer_packed", 3, ["shared_online_plain"]),  # odd H falls through to kv_outer
    ("kv_outer_future", 2, ["shared_online_plain"]),  # JAX: any kv_outer* string -> KV-outer
    ("no_such_algo", 2, ["shared_online_plain"]),     # JAX: anything else -> Q-outer
])
def test_online_shared_algos_route(rng, monkeypatch, algo, heads, plain):
    """INSTANTRESTORE_ATTN_ALGO routes the online-max family as the JAX
    package does (the pair kernel's plain version is shared_online's on an
    even number of heads, so it records both), and the result is the Pallas
    kernel's that JAX runs under the same string."""
    monkeypatch.setenv("INSTANTRESTORE_ATTN_ALGO", algo)
    q, k_in, v_in, rk, rv = _shared_inputs(rng, 4, h=heads)
    ref = jsa.shared_flash_attention(*(jnp.asarray(x) for x in (q, k_in, v_in, rk, rv)),
                                     scale=0.25, block_q=16, block_k=16, interpret=True)
    calls = _record_plain_calls(monkeypatch)
    out = tsa.shared_flash_attention(*(_t(x) for x in (q, k_in, v_in, rk, rv)), scale=0.25)
    assert calls == plain
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_flash_algo_env(rng, monkeypatch):
    """INSTANTRESTORE_FLASH_ALGO selects the algorithm as in JAX: ``bound``
    runs the bound kernel, ``online`` and any other value the online one
    (the TPU's _flash_kernel)."""
    q, k, v = (_t(rng.normal(size=(1, 2, 32, 16))) for _ in range(3))
    calls = _record_plain_calls(monkeypatch)
    for algo in ("bound", "online", "anything_else"):
        monkeypatch.setenv("INSTANTRESTORE_FLASH_ALGO", algo)
        out = tsa.flash_attention(q, k, v, scale=0.25)
        torch.testing.assert_close(out, tsa.flash_attention_plain(q, k, v, scale=0.25),
                                   rtol=2e-5, atol=2e-5)
    assert calls == ["flash_attention_plain"] * 2 + ["flash_online_plain",
                                                     "flash_attention_plain"] * 2


def test_wrappers_reject_other_devices():
    q = torch.zeros((1, 1, 64, 64), device="meta")
    with pytest.raises(ValueError):
        tsa.flash_attention(q, q, q, scale=0.125)
    r = torch.zeros((1, 2, 1, 64, 64), device="meta")
    aff = torch.zeros((1, 1, 2, 2, 64), device="meta")
    with pytest.raises(ValueError):
        tsa.shared_flash_bound(q, q, q, r, r, aff, torch.zeros((1, 1), device="meta"),
                               scale=0.125, include_input=True)
    with pytest.raises(ValueError):
        tsa.shared_identity(q, r, r, aff, torch.zeros((1, 1), device="meta"),
                            torch.zeros(1, dtype=torch.long), scale=0.125)
    with pytest.raises(ValueError):
        tsa.flash_online(q, q, q, scale=0.125)
    for wrapper in (tsa.shared_online, tsa.shared_online_pair):
        with pytest.raises(ValueError):
            wrapper(q, q, q, r, r, aff, scale=0.125, include_input=True)
