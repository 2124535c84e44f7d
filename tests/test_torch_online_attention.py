"""The port's online-max attention family vs the JAX package's Pallas kernels
(_flash_kernel, _shared_kvouter_kernel, _shared_kernel,
_shared_kvouter_packed_kernel), and the slice end to end under
INSTANTRESTORE_ATTN_ALGO=kv_outer + INSTANTRESTORE_FLASH_ALGO=online.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels are held against those same plain versions on the card by
chip_smoke.py); the JAX side runs its Pallas kernels in interpret mode with an
explicit ``algo``. fp32, tolerance 2e-5 absolute: the two differ in fp32
summation order and in the key chunk of the running max, which in fp32 is
summation order too. The bf16 cases state their own tolerances: there the
chunk shows, because bf16(s - m_new) depends on the running max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.inference import predictor as jpred
from instantrestore_tpu.inference import serving as jserving
from instantrestore_tpu.ops import shared_attention as jsa
from instantrestore_tpu_torch.inference import predictor as tpred
from instantrestore_tpu_torch.inference.serving import ServingEngine
from instantrestore_tpu_torch.ops import _build
from instantrestore_tpu_torch.ops import shared_attention as tsa

from test_torch_attention_kernels import (
    TOL,
    _bf16,
    _bf16_err,
    _record_plain_calls,
    _shared_inputs,
    _t,
    record_calls,
)
from test_torch_cold import B, J_STATICS, N, RES, T_STATICS, jax_draws, models  # noqa: F401

SHARED_ALGOS = ("kv_outer", "q_outer", "kv_outer_packed")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, more threads only
    contend (as ``tests/test_torch_coach.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_kernel_build(monkeypatch):
    """CPU tensors must never reach the CUDA build."""
    def refuse(name):
        raise AssertionError(f"CPU path tried to load kernel {name}")
    monkeypatch.setattr(_build, "load", refuse)
    tsa.reset_launch_counts()
    yield
    assert not any(fn.launches for fn in tsa.KERNEL_WRAPPERS)


def _j(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


@pytest.mark.parametrize("b,h,s,skv,d", [
    (2, 3, 64, 64, 16), (2, 2, 64, 128, 64), (1, 1, 32, 64, 512),
])
def test_flash_online_matches_pallas(rng, b, h, s, skv, d):
    """Row 8 at both of its branches (d < 128: rounded exponent argument and
    ones-column sum; d >= 128: fp32 p and VPU sum), the JAX kernel on two key
    blocks, the port on its own chunk and on JAX's."""
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k = rng.normal(size=(b, h, skv, d)).astype(np.float32)
    v = rng.normal(size=(b, h, skv, d)).astype(np.float32)
    scale = d ** -0.5
    ref = jsa.flash_attention(*_j(q, k, v), scale=scale, block_q=32, block_k=skv // 2,
                              interpret=True, algo="online")
    out = tsa.flash_attention(_t(q), _t(k), _t(v), scale=scale, algo="online")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    for block_k in (tsa.ONLINE_BLOCK_K, skv // 2, 16):
        plain = tsa.flash_online_plain(_t(q), _t(k), _t(v), scale=scale, block_k=block_k)
        np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **TOL)


def test_online_plain_matches_softmax_and_checks_its_chunk(rng):
    q, k, v = (_t(rng.normal(size=(2, 2, 32, 16))) for _ in range(3))
    ref = torch.softmax(q @ k.transpose(-1, -2) * 0.25, dim=-1) @ v
    np.testing.assert_allclose(tsa.flash_online_plain(q, k, v, scale=0.25, block_k=8).numpy(),
                               ref.numpy(), **TOL)
    # a chunk that does not divide the keys leaves a ragged last chunk (12,
    # 12, 8), in each segment of a shared call: the same function
    np.testing.assert_allclose(tsa.flash_online_plain(q, k, v, scale=0.25, block_k=12).numpy(),
                               ref.numpy(), **TOL)
    r = torch.zeros((2, 1, 2, 32, 16))
    aff = tsa._affine(None, 2, 2, 1, 16, "cpu")
    np.testing.assert_allclose(
        tsa.shared_online_plain(q, k, v, r, r, aff, scale=0.25, include_input=True,
                                block_k=12).numpy(),
        tsa.shared_online_plain(q, k, v, r, r, aff, scale=0.25, include_input=True,
                                block_k=32).numpy(), **TOL)
    with pytest.raises(ValueError, match="chunk"):
        tsa.shared_online_plain(q, k, v, r, r, aff, scale=0.25, include_input=True, block_k=0)
    with pytest.raises(ValueError, match="odd"):
        tsa.shared_online_pair_plain(q[:, :1], k[:, :1], v[:, :1], r[:, :, :1], r[:, :, :1],
                                     aff[:, :1], scale=0.25, include_input=True)


@pytest.mark.parametrize("algo", SHARED_ALGOS)
@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("use_adain", [True, False])
@pytest.mark.parametrize("include_input", [True, False])
def test_shared_online_matches_pallas(rng, algo, n, use_adain, include_input):
    """Rows 7, 9 and 10: the port under each algorithm name vs the Pallas
    kernel JAX runs under that name, fp32, N odd and even, one zeroed
    reference (attended with logit 0, never skipped)."""
    q, k_in, v_in, rk, rv = _shared_inputs(rng, n)
    scale = q.shape[-1] ** -0.5
    jaff = jsa.adain_affine(jnp.asarray(v_in), jnp.asarray(rv)) if use_adain else None
    ref = jsa.shared_flash_attention(*_j(q, k_in, v_in, rk, rv), scale=scale, v_affine=jaff,
                                     include_input=include_input, algo=algo, block_q=16,
                                     block_k=16, interpret=True)
    taff = tsa.adain_affine(_t(v_in), _t(rv)) if use_adain else None
    out = tsa.shared_flash_attention(_t(q), _t(k_in), _t(v_in), _t(rk), _t(rv), scale=scale,
                                     v_affine=taff, include_input=include_input, algo=algo)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("include_input", [True, False])
def test_shared_online_names_agree(rng, include_input):
    """Per row the sequence of running maxima is the same under the three
    algorithm names: JAX's three kernels agree to fp32 rounding, the port's
    two kernels' plain versions exactly, at every chunk."""
    q, k_in, v_in, rk, rv = _shared_inputs(rng, 3)
    jaff = jsa.adain_affine(jnp.asarray(v_in), jnp.asarray(rv))
    taff = tsa.adain_affine(_t(v_in), _t(rv))
    jouts, touts = [], []
    for algo in SHARED_ALGOS:
        jouts.append(np.asarray(jsa.shared_flash_attention(
            *_j(q, k_in, v_in, rk, rv), scale=0.25, v_affine=jaff, include_input=include_input,
            algo=algo, block_q=16, block_k=16, interpret=True)))
        touts.append(tsa.shared_flash_attention(
            _t(q), _t(k_in), _t(v_in), _t(rk), _t(rv), scale=0.25, v_affine=taff,
            include_input=include_input, algo=algo).numpy())
    for jo, to in zip(jouts[1:], touts[1:]):
        np.testing.assert_allclose(jo, jouts[0], **TOL)
        np.testing.assert_array_equal(to, touts[0])
    b, h, _, d = q.shape
    aff = tsa._affine(taff, b, h, 3, d, "cpu")
    for block_k in (8, 16):
        plain = tsa.shared_online_plain(_t(q), _t(k_in), _t(v_in), _t(rk), _t(rv), aff,
                                        scale=0.25, include_input=include_input, block_k=block_k)
        np.testing.assert_allclose(plain.numpy(), touts[0], **TOL)


# What bf16 adds to the comparison with Pallas in interpret mode:
# (1) XLA's CPU lowering of a bf16 exp2 multiplies by ln 2 in bf16 before the
#     exponential, so 4 of 5 of its values differ from the correctly rounded
#     exp2 that torch and the CUDA kernels compute. It touches every case that
#     rounds the exponent's argument (d < 128) and dominates them: mean-abs
#     ~4e-4 on outputs of magnitude ~1, max-abs 1 bf16 ulp (3.9e-3).
# (2) The key chunk: bf16(s - m_new) depends on the running max. Where (1) is
#     absent (d = 512, fp32 p) the port on JAX's chunk agrees to the last bit
#     but for a few elements (mean-abs <= 1e-5) and on another chunk to 1e-4.
# (3) The AdaIN affine: one rounding of v * a + c against the TPU kernels'
#     two, within 1 bf16 ulp of the value; with it mean-abs ~8e-4 and max-abs
#     ~1.4e-2 on outputs up to ~1.8.
BF16_PLAIN = dict(mean=1e-3, max=8e-3)     # (1) + (2): 2 ulps at magnitude 1
BF16_AFFINE = dict(mean=1.5e-3, max=2.4e-2)  # (1) + (2) + (3): 3 ulps at magnitude 2


def _assert_bf16(out, ref, tol):
    max_abs, mean_abs = _bf16_err(out, ref)
    assert mean_abs <= tol["mean"] and max_abs <= tol["max"], (max_abs, mean_abs)


@pytest.mark.parametrize("d,skv", [(64, 128), (512, 64)])
def test_flash_online_bf16_matches_pallas(rng, d, skv):
    """bf16, both branches of row 8 (the cast before exp2 at d < 128, fp32 p
    at d >= 128), through the wrapper on the CUDA tile's chunk (128 keys
    against JAX's 32 here at d = 64; at d = 512 the tile's 32, JAX's own) and,
    at d = 512, on JAX's chunk to the last bit."""
    q = rng.normal(size=(2, 2, 64, d)).astype(np.float32)
    k = rng.normal(size=(2, 2, skv, d)).astype(np.float32)
    v = rng.normal(size=(2, 2, skv, d)).astype(np.float32)
    scale = d ** -0.5
    ref = jsa.flash_attention(*_j(q, k, v, dtype=jnp.bfloat16), scale=scale, block_q=32,
                              block_k=32, interpret=True, algo="online")
    out = tsa.flash_attention(_bf16(q), _bf16(k), _bf16(v), scale=scale, algo="online")
    assert out.dtype == torch.bfloat16
    _assert_bf16(out, ref, BF16_PLAIN)
    if d >= 128:
        _assert_bf16(out, ref, dict(mean=1e-4, max=8e-3))
        same = tsa.flash_online_plain(_bf16(q), _bf16(k), _bf16(v), scale=scale, block_k=32)
        _assert_bf16(same, ref, dict(mean=1e-5, max=8e-3))
        assert torch.equal(out, same)  # the wrapper's chunk at d = 512 is JAX's 32


@pytest.mark.parametrize("algo", SHARED_ALGOS)
@pytest.mark.parametrize("include_input", [True, False])
def test_shared_online_bf16_matches_pallas(rng, algo, include_input):
    """bf16 under each algorithm name, with the AdaIN affine and without, the
    port on its own chunk of 64 keys against JAX's 32."""
    q, k_in, v_in, rk, rv = _shared_inputs(rng, 4, s=64, d=64)
    j = _j(q, k_in, v_in, rk, rv, dtype=jnp.bfloat16)
    t = [_bf16(x) for x in (q, k_in, v_in, rk, rv)]
    jkw = dict(scale=0.125, include_input=include_input, algo=algo, block_q=32, block_k=32,
               interpret=True)
    tkw = dict(scale=0.125, include_input=include_input, algo=algo)
    out = tsa.shared_flash_attention(*t, v_affine=tsa.adain_affine(t[2], t[4]), **tkw)
    assert out.dtype == torch.bfloat16
    _assert_bf16(out, jsa.shared_flash_attention(*j, v_affine=jsa.adain_affine(j[2], j[4]), **jkw),
                 BF16_AFFINE)
    _assert_bf16(tsa.shared_flash_attention(*t, **tkw), jsa.shared_flash_attention(*j, **jkw),
                 BF16_PLAIN)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_escape_hatch_beyond_190_log2_units(rng, dtype):
    """One large-norm key orthogonal to every query puts the bound thousands
    of log2 units above every score: each p of the bound softmax flushes to 0
    and the rows come out 0 / 0, in JAX's kernel and in the port's alike. The
    online kernels are finite on the same inputs and agree."""
    b, h, s, d, n = 1, 2, 32, 16, 2
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    q[..., d // 2:] = 0.0
    k_in = rng.normal(size=(b, h, s, d)).astype(np.float32)
    v_in = rng.normal(size=(b, h, s, d)).astype(np.float32)
    rk = rng.normal(size=(b, n, h, s, d)).astype(np.float32)
    rv = rng.normal(size=(b, n, h, s, d)).astype(np.float32)
    rk[:, 1, :, 5, :] = 0.0
    rk[:, 1, :, 5, d - 1] = 4096.0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = _j(q, k_in, v_in, rk, rv, dtype=jdt)
    t = [_t(x).to(tdt) for x in (q, k_in, v_in, rk, rv)]
    slack = tsa.LOG2E * 0.25 * np.linalg.norm(q, axis=-1).min() * 4096.0
    assert slack > 190 * 4
    kw = dict(scale=0.25, include_input=False)
    jbound = jsa.shared_flash_attention(*j, algo="kv_outer_bound", block_q=16, block_k=16,
                                        interpret=True, **kw)
    tbound = tsa.shared_flash_attention(*t, algo="kv_outer_bound", **kw)
    assert not np.isfinite(np.asarray(jbound.astype(jnp.float32))).any()
    assert not torch.isfinite(tbound).any()
    jonline = jsa.shared_flash_attention(*j, algo="kv_outer", block_q=16, block_k=16,
                                         interpret=True, **kw)
    tonline = tsa.shared_flash_attention(*t, algo="kv_outer", **kw)
    assert torch.isfinite(tonline).all()
    if dtype == "float32":
        np.testing.assert_allclose(tonline.numpy(), np.asarray(jonline), **TOL)
    else:  # chunk 32 against JAX's 16, no affine
        _assert_bf16(tonline, jonline, BF16_PLAIN)


def test_online_rows_of_equal_scores_are_finite():
    """alpha on the first chunk is exp2(-1e30 - m_new) = 0 and the
    accumulators start at 0: an all-zero score row gives the mean of v."""
    q = torch.zeros((1, 2, 16, 16))
    k, v = torch.ones((1, 2, 32, 16)), torch.arange(32.0).repeat(1, 2, 16, 1).transpose(-1, -2)
    out = tsa.flash_online_plain(q, k, v, scale=0.25, block_k=8)
    torch.testing.assert_close(out, torch.full_like(out, 15.5))
    r = torch.zeros((1, 2, 2, 32, 16))
    out = tsa.shared_online_plain(q, k[:, :, :32], v, r, r, tsa._affine(None, 1, 2, 2, 16, "cpu"),
                                  scale=0.25, include_input=True, block_k=8)
    torch.testing.assert_close(out, torch.full_like(out, 15.5 / 3))


@pytest.mark.parametrize("sq,s,h,pair,tile", [
    (4096, 4096, 5, False, (128, 128)), (1024, 1024, 10, False, (128, 128)),
    (256, 256, 20, False, (128, 128)), (1024, 1024, 10, True, (64, 128)),
    (256, 256, 20, True, (64, 128)), (64, 256, 4, False, (64, 128)),
    (192, 256, 4, False, (64, 128)), (256, 64, 4, False, (128, 64)),
    (256, 192, 4, True, (64, 64)), (64, 64, 2, True, (64, 64)),
])
def test_shared_online_tile_follows_the_shape(sq, s, h, pair, tile):
    """The thread block of the online shared kernels (128 query rows on one
    head where 128 divides Sq, else 64; a head pair 64 rows a head) and the key
    chunk (128 where it divides the segment, else 64) at the full-size shapes
    of a 512 px restore, at Sq = 64 and at S = 64."""
    assert tsa.shared_online_tile(sq, s, h, pair=pair) == tile
    assert tsa.shared_online_chunk(s) == tile[1]


@pytest.mark.parametrize("sq,s,h,pair", [
    (96, 128, 4, False), (128, 96, 4, False), (128, 128, 5, True), (0, 128, 4, False),
    (128, 160, 4, True),
])
def test_shared_online_tile_refuses(sq, s, h, pair):
    """An empty side or a head pair of odd H: no tile. Sq or S off 64 take
    the tile (a ragged last key tile of each segment is masked, query rows
    past Sq are neither read nor written): 64 rows a block and the key chunk
    of ``shared_online_chunk``."""
    if min(sq, s) > 0 and not (pair and h % 2):
        assert tsa.shared_online_tile(sq, s, h, pair=pair) == (64, tsa.shared_online_chunk(s))
        assert tsa.shared_online_chunk(s) == min(s, 128 if s > 64 else 64)
        return
    with pytest.raises(ValueError, match="unsupported"):
        tsa.shared_online_tile(sq, s, h, pair=pair)


def test_shared_online_wrapper_refuses_what_the_kernel_refuses(monkeypatch):
    """The shape rule of the launch path, on meta tensors: a refused shape
    (a head pair of odd H) raises before any kernel is loaded; Sq or S off 64
    reach the load (the fixture fails a load)."""
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    monkeypatch.setattr(tsa._build, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for wrapper, source, hpb, (h, sq, s) in [
            (tsa.shared_online, "shared_online", 1, (2, 96, 64)),
            (tsa.shared_online, "shared_online", 1, (2, 64, 96)),
            (tsa.shared_online_pair, "shared_online_pair", 2, (3, 64, 64))]:
        refused = h % 2 and hpb == 2
        with pytest.raises(ValueError if refused else AssertionError,
                           match="unsupported" if refused else f"tried to load kernel {source}"):
            tsa._launch_shared_online(
                wrapper, source, meta(1, h, sq, 64), None, None, meta(1, 2, h, s, 64),
                meta(1, 2, h, s, 64), meta(1, h, 2, 2, 64, dtype=torch.float32), scale=0.125,
                include_input=False, heads_per_block=hpb)


@pytest.mark.parametrize("chunk", [tsa.ONLINE_BLOCK_K, tsa.SHARED_ONLINE_BLOCK_K])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("include_input", [True, False])
def test_shared_online_plain_at_the_kernel_chunks_matches_pallas(rng, chunk, dtype, include_input):
    """``shared_online_plain`` on the two key chunks the CUDA kernels take (64
    and 128 keys; segments of 128 keys, d = 64, AdaIN affine, one zeroed
    reference) against ``_shared_kvouter_kernel`` in interpret mode on the
    same chunk: fp32 to 2e-5, bf16 to BF16_AFFINE (the chunk is JAX's, so
    what remains is XLA-CPU's bf16 exp2 and the affine's one rounding). The
    default chunk is the larger one where it divides the segment."""
    q, k_in, v_in, rk, rv = _shared_inputs(rng, 2, b=2, h=2, s=128, d=64)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = _j(q, k_in, v_in, rk, rv, dtype=jdt)
    t = [_t(x).to(tdt) for x in (q, k_in, v_in, rk, rv)]
    ref = jsa.shared_flash_attention(*j, scale=0.125, v_affine=jsa.adain_affine(j[2], j[4]),
                                     include_input=include_input, algo="kv_outer", block_q=64,
                                     block_k=chunk, interpret=True)
    aff = tsa._affine(tsa.adain_affine(t[2], t[4]), 2, 2, 2, 64, "cpu")
    kw = dict(scale=0.125, include_input=include_input)
    out = tsa.shared_online_plain(*t, aff, block_k=chunk, **kw)
    assert out.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    else:
        _assert_bf16(out, ref, BF16_AFFINE)
    if chunk == tsa.SHARED_ONLINE_BLOCK_K:  # the default follows the kernel's choice
        assert torch.equal(tsa.shared_online_plain(*t, aff, **kw), out)
        assert torch.equal(tsa.shared_online_pair_plain(*t, aff, **kw), out)
        assert torch.equal(tsa.shared_online(*t, aff, **kw), out)


# ---------------------------------------------------------------------------
# the slice end to end: cold restore and the Predictor under the online
# algorithms, fused attention on both sides (JAX: Pallas in interpret mode)
# ---------------------------------------------------------------------------


@pytest.fixture
def online_env(monkeypatch):
    """jax.jit reads the algorithm switches while it traces, so they are set
    before the JAX side builds (and first calls) its jitted functions; the
    tests below make new engines and never reuse a traced one."""
    monkeypatch.setenv("INSTANTRESTORE_ATTN_ALGO", "kv_outer")
    monkeypatch.setenv("INSTANTRESTORE_FLASH_ALGO", "online")


def test_cold_restore_under_online_algos_matches_jax(models, online_env, monkeypatch):  # noqa: F811
    """ServingEngine.restore_cold on uint8 inputs, both packages fused under
    kv_outer + online: 1e-3 max-abs on the output image, as the default
    algorithm's cold tests. Both sides provably ran the online kernels."""
    jcalls = record_calls(monkeypatch, jsa, ["_shared_flash_attention_kvouter", "_flash_attention_bound",
                                        "_shared_flash_attention_kvouter_bound"])
    rng = jax.random.PRNGKey(21)
    jeng = jserving.ServingEngine(models["jax"], J_STATICS, use_fused_attention=True)
    ref = jeng.restore_cold(jnp.asarray(models["images"]), jnp.asarray(models["refs"]), rng)
    assert set(jcalls) == {"_shared_flash_attention_kvouter"}
    draws = jax_draws(jserving._per_sample_keys(rng, B), B, N)
    tcalls = _record_plain_calls(monkeypatch)
    engine = ServingEngine(models["torch"], T_STATICS, device="cpu")
    out = engine.restore_cold(torch.from_numpy(models["images"]), torch.from_numpy(models["refs"]),
                              noise=draws)
    assert set(tcalls) == {"shared_online_plain", "flash_online_plain"}
    assert tcalls.count("shared_online_plain") == 9
    assert out.shape == (B, RES, RES, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


def test_predictor_under_online_algos_matches_jax(models, online_env, monkeypatch, rng):  # noqa: F811
    """Predictor.predict_batch, fused, under kv_outer + online: the float
    outputs of the two packages agree to 1e-3."""
    jp = jpred.Predictor(params=models["jax"], statics=J_STATICS, dtype=jnp.float32,
                         resolution=RES, deterministic=True, seed=3, use_fused_attention=True)
    tp = tpred.Predictor(params=models["torch"], statics=T_STATICS, dtype=torch.float32,
                         resolution=RES, deterministic=True, seed=3, device="cpu",
                         use_fused_attention=True)
    images = rng.uniform(-1, 1, (1, RES, RES, 3)).astype(np.float32)
    conds = rng.uniform(-1, 1, (1, 4, RES, RES, 3)).astype(np.float32)
    ref = jp.predict_batch(images, conds)
    tcalls = _record_plain_calls(monkeypatch)
    # predict_batch splits the Predictor's key once and draws from the second half
    noise = jax_draws(jax.random.split(jax.random.PRNGKey(3))[1], 1, 4, sample_posterior=False)
    out = tp.predict_batch(images, conds, noise=noise)
    assert set(tcalls) == {"shared_online_plain", "flash_online_plain"}
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-3)
