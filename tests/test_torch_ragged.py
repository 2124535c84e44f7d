"""Attention at every shape the JAX kernels take: Sq, Skv and segment lengths
off the CUDA tiles' 64 rows (a UNet whose ``sample_size`` is not a multiple
of 64 gives them: 16 tokens in the mid block at 32, 144, 36 and 9 at 24).

The JAX kernels take any length up to their block (``bq = min(block_q,
sq)``, ``bk = min(block_k, skv)``, 1024 at d <= 128). The port's tiles mask
the keys past a segment's end and leave the query rows past Sq unwritten, so
its shape rules take every such shape at d = 64; d = 512 keeps the VAE mid
attention's shapes (Sq % 64, Skv % 32), which n^2 tokens of a latent side n,
a multiple of 8, always meet. The key chunk of the running max is the
kernel's 128 or 64 keys with a ragged last chunk in each segment
(``key_tile``), the same in kernel and plain version.

Here: a walk over every fused attention of the UNet and VAE at sample_size
8, 16, 24, 32 and 64, full-width heads, in which each wrapper's shape rule
takes the shape wherever JAX's assert does (on meta tensors made to look like
the card's: the call reaches the kernel's load, which the fixture refuses);
the plain versions of rows 1-10 at Sq = Skv = S in {1, 4, 16, 36, 144}
against the Pallas kernels in interpret mode (fp32, 2e-5, as
``tests/test_torch_attention_kernels.py``; the backward 5e-5, the LSE 2e-4,
as ``tests/test_torch_flash_vjp.py``); and the gradient of the differentiable
attention at (144, 144, 64) against JAX's (1e-4, as there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.ops import flash_vjp as jfv
from instantrestore_tpu.ops import shared_attention as jsa
from instantrestore_tpu_torch.models.unet import UNetConfig
from instantrestore_tpu_torch.ops import _build
from instantrestore_tpu_torch.ops import flash_vjp as tfv
from instantrestore_tpu_torch.ops import shared_attention as tsa

from test_torch_attention_kernels import TOL, _t

SAMPLE_SIZES = (8, 16, 24, 32, 64)
RAGGED = (1, 4, 16, 36, 144)
N_REFS = 4
SHARED_ALGOS = ("kv_outer_bound", "kv_outer_bound_paired", "kv_outer", "q_outer",
                "kv_outer_packed")


@pytest.fixture(autouse=True)
def no_kernel_build(monkeypatch):
    """CPU tensors must never reach the CUDA build."""
    def refuse(name):
        raise AssertionError(f"CPU path tried to load kernel {name}")
    monkeypatch.setattr(_build, "load", refuse)
    tfv.reset_launch_counts()
    yield
    assert not any(fn.launches for fn in tfv.KERNEL_WRAPPERS)


# ---------------------------------------------------------------------------
# the shape walk
# ---------------------------------------------------------------------------


def model_shapes(size: int):
    """{kind: [(heads, Sq, Skv or segment length, d)]} of every fused
    attention of the full-width UNet and VAE at ``sample_size``: the down
    blocks' and the mid block's self-attention (plain), the up blocks' shared
    self-attention over reference segments of as many tokens as the query
    (shared), the VAE encoder's and decoder's mid attention (vae). A stride-2
    convolution halves a side rounding up."""
    cfg = UNetConfig()
    sides = [size]
    for _ in range(3):
        sides.append(-(-sides[-1] // 2))
    heads = cfg.attention_heads
    d = cfg.block_out_channels[0] // heads[0]
    plain = [(heads[i], sides[i] ** 2, sides[i] ** 2, d) for i in range(3)]
    plain.append((heads[-1], sides[3] ** 2, sides[3] ** 2, d))
    shared = [(heads[2 - i], sides[2 - i] ** 2, sides[2 - i] ** 2, d) for i in range(3)]
    vae = [(1, size ** 2, size ** 2, 512)]
    return {"plain": plain, "shared": shared, "vae": vae}


def jax_takes(sq: int, skv: int, d: int) -> bool:
    """JAX's assert over its default blocks (1024 at d <= 128, else 512)."""
    block = 1024 if d <= 128 else 512
    return sq % min(block, sq) == 0 and skv % min(block, skv) == 0


def _cuda_like(monkeypatch):
    monkeypatch.setattr(tsa._build, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _reaches_load(fn, name):
    with pytest.raises(AssertionError, match=f"tried to load kernel {name}"):
        fn()


def test_model_shapes_are_the_ones_the_issue_names():
    """At sample_size 32 the mid block has 16 tokens; at 24 the UNet has 576,
    144, 36 and 9; at 64 (512 px) every shape is a multiple of 64."""
    assert model_shapes(32)["plain"][-1][1] == 16
    assert {s for _, s, _, _ in model_shapes(24)["plain"]} == {576, 144, 36, 9}
    assert {s for _, s, _, _ in model_shapes(24)["shared"]} == {576, 144, 36}
    assert all(s % 64 == 0 for shapes in model_shapes(64).values() for _, s, _, _ in shapes)


@pytest.mark.parametrize("kind", ["plain", "shared", "vae"])
@pytest.mark.parametrize("size", SAMPLE_SIZES)
def test_every_model_shape_jax_takes_the_port_takes(monkeypatch, size, kind):
    """Each wrapper's shape rule takes every shape of the walk that JAX's
    assert takes: the serving kernels, the training forward (plain, and
    widened over 4 references with and without the input segment) and both
    backward kernels reach their load."""
    _cuda_like(monkeypatch)
    for h, sq, skv, d in model_shapes(size)[kind]:
        widths = [skv] if kind != "shared" else [N_REFS * skv, (N_REFS + 1) * skv]
        if not jax_takes(sq, skv, d):
            continue
        q = _meta(2, h, sq, d)
        scale = d ** -0.5
        if kind == "shared":
            k_in, v_in = _meta(2, h, skv, d), _meta(2, h, skv, d)
            rk, rv = _meta(2, N_REFS, h, skv, d), _meta(2, N_REFS, h, skv, d)
            source = {"kv_outer_bound": "shared_flash_bound",
                      "kv_outer_bound_paired": "shared_identity", "kv_outer": "shared_online",
                      "q_outer": "shared_online", "kv_outer_packed": "shared_online_pair"}
            for algo in SHARED_ALGOS:
                for inc in (False, True):
                    want = source[algo]
                    if inc and algo == "kv_outer_bound_paired":
                        want = "shared_flash_bound"
                    if algo == "kv_outer_packed" and h % 2:
                        want = "shared_online"
                    _reaches_load(lambda: tsa.shared_flash_attention(
                        q, k_in, v_in, rk, rv, scale=scale, include_input=inc, algo=algo), want)
            (cache,) = tsa.build_identity_kv_cache([(_meta(3, N_REFS, h, skv, d),
                                                     _meta(3, N_REFS, h, skv, d))])
            _reaches_load(lambda: tsa.shared_attention_identity(
                q, None, v_in, cache, torch.tensor([2, 0], device="meta"), scale=scale,
                use_adain=True),
                "shared_identity")
            for w in widths:  # the widened training forward over [input |] 4 references
                if not jax_takes(sq, w, d):
                    continue
                chunk = (tsa.shared_online_chunk(skv) if skv % tsa.ONLINE_BLOCK_K == 0
                         else tsa.flash_online_chunk(w, d))
                tsa.check_flash_chunk("flash_fwd_lse", w, d, chunk)
                assert tsa._flash_tiles_fit(sq, w, d)
                tfv.flash_bwd_tiles(sq, w, d)
        else:
            k = _meta(2, h, skv, d)
            for algo, name in (("bound", "flash_bound"), ("online", "flash_online")):
                _reaches_load(lambda: tsa.flash_attention(q, k, k, scale=scale, algo=algo), name)
            _reaches_load(lambda: tfv.flash_fwd_lse(q, k, k, scale=scale), "flash_fwd_lse")
            lse = _meta(2, h, sq, dtype=torch.float32)
            for name in ("flash_bwd_dq", "flash_bwd_dkv"):
                _reaches_load(lambda: getattr(tfv, name)(q, k, k, q, lse, lse, scale=scale),
                              name)


# ---------------------------------------------------------------------------
# the plain versions at ragged shapes against the Pallas kernels
# ---------------------------------------------------------------------------


def _qkv(rng, b, h, sq, skv, d):
    return [rng.normal(size=(b, h, n, d)).astype(np.float32) for n in (sq, skv, skv)]


@pytest.mark.parametrize("row", ["flash_bound", "flash_online", "fwd_lse", "backward"])
@pytest.mark.parametrize("s", RAGGED)
def test_flash_rows_match_pallas_at_ragged_shapes(rng, s, row):
    """Rows 2, 8, 4 and 5-6 at Sq = Skv = S, d = 64: the port's default chunk
    (128 then 16 keys at 144, one chunk elsewhere) against JAX's one block;
    in fp32 the chunk orders the sums only."""
    b, h, d = 2, 2, 64
    q, k, v = _qkv(rng, b, h, s, s, d)
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = _t(q), _t(k), _t(v)
    if row in ("flash_bound", "flash_online"):
        algo = row.split("_")[1]
        ref = jsa.flash_attention(jq, jk, jv, scale=scale, interpret=True, algo=algo)
        out = tsa.flash_attention(tq, tk, tv, scale=scale, algo=algo)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        return
    o, lse = jfv._flash_forward_lse(jq, jk, jv, scale, s, s, True)
    tout, tlse = tfv.flash_fwd_lse(tq, tk, tv, scale=scale)
    if row == "fwd_lse":
        np.testing.assert_allclose(tout.numpy(), np.asarray(o), **TOL)
        np.testing.assert_allclose(tlse.numpy(), np.asarray(lse[..., 0]), atol=2e-4)
        return
    ct = rng.normal(size=(b, h, s, d)).astype(np.float32)
    dq, dk, dv = jfv._flash_backward(jq, jk, jv, o, lse, jnp.asarray(ct), scale, s, s, True)
    delta = (_t(ct) * _t(o)).sum(-1)
    args = (tq, tk, tv, _t(ct), _t(lse[..., 0]), delta)
    np.testing.assert_allclose(tfv.flash_bwd_dq(*args, scale=scale).numpy(), np.asarray(dq),
                               atol=5e-5)
    tdk, tdv = tfv.flash_bwd_dkv(*args, scale=scale)
    np.testing.assert_allclose(tdk.numpy(), np.asarray(dk), atol=5e-5)
    np.testing.assert_allclose(tdv.numpy(), np.asarray(dv), atol=5e-5)


@pytest.mark.parametrize("algo", SHARED_ALGOS + ("identity",))
@pytest.mark.parametrize("s", RAGGED)
def test_shared_rows_match_pallas_at_ragged_shapes(rng, s, algo):
    """Rows 3, 1b, 7, 9 and 10 (per-call references, refs-only and with the
    input segment where the algorithm takes it) and row 1 (the identity cache
    by id) at Sq = S, d = 64, 4 references with the AdaIN affine (none at
    S = 1, where its unbiased std over one token is undefined in both
    packages): the port's chunk within each segment against JAX's one
    block."""
    b, h, d = 2, 2, 64
    scale = d ** -0.5
    q, k_in, v_in = _qkv(rng, b, h, s, s, d)
    adain = s > 1
    if algo == "identity":
        rk = rng.normal(size=(3, N_REFS, h, s, d)).astype(np.float32)
        rv = (rng.normal(size=(3, N_REFS, h, s, d)) * 0.7 - 0.3).astype(np.float32)
        ids = [2, 0]
        (jcache,) = jsa.build_identity_kv_cache([(jnp.asarray(rk), jnp.asarray(rv))], block_k=s)
        ref = jsa.shared_attention_identity(
            jnp.asarray(q), jnp.asarray(k_in), jnp.asarray(v_in), jcache,
            jnp.asarray(ids, jnp.int32), scale=scale, use_adain=adain, block_q=s,
            interpret=True)
        (tcache,) = tsa.build_identity_kv_cache([(_t(rk), _t(rv))])
        out = tsa.shared_attention_identity(_t(q), _t(k_in), _t(v_in), tcache,
                                            torch.tensor(ids), scale=scale, use_adain=adain)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        return
    rk = rng.normal(size=(b, N_REFS, h, s, d)).astype(np.float32)
    rv = (rng.normal(size=(b, N_REFS, h, s, d)) * 0.7 - 0.3).astype(np.float32)
    j = [jnp.asarray(x) for x in (q, k_in, v_in, rk, rv)]
    t = [_t(x) for x in (q, k_in, v_in, rk, rv)]
    for inc in ((False,) if algo == "kv_outer_packed" else (False, True)):
        jaff = jsa.adain_affine(j[2], j[4]) if adain else None
        taff = tsa.adain_affine(t[2], t[4]) if adain else None
        ref = jsa.shared_flash_attention(*j, scale=scale, v_affine=jaff, include_input=inc,
                                         algo=algo, interpret=True)
        out = tsa.shared_flash_attention(*t, scale=scale, v_affine=taff, include_input=inc,
                                         algo=algo)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL, err_msg=f"input={inc}")


def test_ragged_chunks_stay_in_their_segment(rng):
    """At 144 keys a segment's chunks are 128 and 16 keys, in each segment of
    a shared call (no chunk straddles two segments): the running max is
    taken at 0, 128, 144 and 272 over two segments. A segment shorter than a
    tile is one chunk, as JAX's one block of it."""
    assert tsa._chunk_starts(288, 128, 144) == [(0, 128), (128, 144), (144, 272), (272, 288)]
    assert tsa._chunk_starts(144, 128, 144) == [(0, 128), (128, 144)]
    assert tsa.shared_online_chunk(144) == tsa.flash_online_chunk(144, 64) == 128
    assert [tsa.shared_online_chunk(s) for s in (36, 16, 9, 4, 1)] == [36, 16, 9, 4, 1]


# ---------------------------------------------------------------------------
# the differentiable attention at a ragged shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,skv", [(144, 144), (36, 144)])
def test_flash_attention_gradient_at_ragged_shapes(rng, sq, skv):
    """``flash_vjp.flash_attention`` at d = 64: the forward, and dQ, dK, dV of
    the port's forward-with-LSE and backward plain versions against JAX's
    custom VJP over its Pallas kernels, 1e-4."""
    d = 64
    q, k, v = _qkv(rng, 1, 2, sq, skv, d)
    ct = rng.normal(size=(1, 2, sq, d)).astype(np.float32)
    scale = d ** -0.5

    def loss(q_, k_, v_):
        o = jfv.flash_attention(q_, k_, v_, scale=scale, interpret=True)
        return jnp.sum(o * jnp.asarray(ct))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = tfv.flash_attention(tq, tk, tv, scale=scale)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(ct))
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, err_msg=f"d{name}")
