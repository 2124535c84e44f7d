"""The key chunk of the running max of ``flash_online`` and ``flash_fwd_lse``
(rows 8 and 4 of PERF.md's kernel table).

At d = 64 both kernels run on the wgmma tile of ``csrc/attn_wgmma.cuh``,
whose chunk is 128 keys where 128 divides Skv, 64 where 64 does, and
otherwise 128 (64 where Skv is shorter) with a ragged last chunk; at d = 512 on
the wgmma tile of ``csrc/attn_wgmma_d512.cuh``, whose chunk is its 32-key
tile. The result depends on the chunk at bf16 rounding level, so one Python
rule (``flash_online_chunk``) gives the chunk to the kernels and to their
plain versions. Here: the plain versions on their default chunk against the
Pallas kernels in interpret mode on the same chunk (fp32 to 2e-5, the LSE to
2e-4 as in ``tests/test_torch_flash_vjp.py``; bf16 at d = 64 to mean-abs
1e-3, XLA-CPU's bf16 exp2 as in ``tests/test_torch_online_attention.py``, at
d = 512, where p stays fp32, to mean-abs 1e-5), the rule over every shape
``chip_smoke.py`` and ``scripts/torch_kernels.py`` launch, the chunk of the
widened shared forward, and the wrappers' refusal of a chunk or a shape the
kernels do not take, before any launch.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.ops import flash_vjp as jfv
from instantrestore_tpu.ops import shared_attention as jsa
from instantrestore_tpu_torch.ops import _build
from instantrestore_tpu_torch.ops import flash_vjp as tfv
from instantrestore_tpu_torch.ops import shared_attention as tsa

from test_torch_attention_kernels import TOL, _bf16, _bf16_err, _t

ROOT = Path(__file__).resolve().parent.parent
# (B, H, Sq, Skv, d): two and three 128-key chunks at d = 64; three 32-key
# chunks against 64 queries and two against 128 at d = 512
SHAPES = [(1, 2, 64, 256, 64), (1, 2, 128, 384, 64), (1, 1, 64, 96, 512), (2, 1, 128, 64, 512)]


@pytest.fixture(autouse=True)
def no_kernel_build(monkeypatch):
    """CPU tensors must never reach the CUDA build."""
    def refuse(name):
        raise AssertionError(f"CPU path tried to load kernel {name}")
    monkeypatch.setattr(_build, "load", refuse)
    tfv.reset_launch_counts()
    yield
    assert not any(fn.launches for fn in tfv.KERNEL_WRAPPERS)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qkv(rng, b, h, sq, skv, d):
    return [rng.normal(size=(b, h, n, d)).astype(np.float32) for n in (sq, skv, skv)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES)
def test_flash_online_default_chunk_matches_pallas(rng, b, h, sq, skv, d, dtype):
    """Row 8's plain version on its default chunk (128 keys at d = 64, 32 at
    d = 512 here) against ``_flash_kernel`` on blocks of that many keys; the
    wrapper's CPU route is the same call."""
    q, k, v = _qkv(rng, b, h, sq, skv, d)
    chunk = 128 if d == 64 else 32
    assert tsa.flash_online_chunk(skv, d) == chunk
    jdt = getattr(jnp, dtype)
    ref = jsa.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), scale=d ** -0.5,
                              block_q=64, block_k=chunk, interpret=True, algo="online")
    t = [_t(x).to(getattr(torch, dtype)) for x in (q, k, v)]
    out = tsa.flash_online_plain(*t, scale=d ** -0.5)
    assert torch.equal(out, tsa.flash_online_plain(*t, scale=d ** -0.5, block_k=chunk))
    assert torch.equal(out, tsa.flash_attention(*t, scale=d ** -0.5, algo="online"))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    else:
        max_abs, mean_abs = _bf16_err(out, ref)
        assert mean_abs <= (1e-3 if d < 128 else 1e-5) and max_abs <= 8e-3, (max_abs, mean_abs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES)
def test_flash_fwd_lse_default_chunk_matches_pallas(rng, b, h, sq, skv, d, dtype):
    """Row 4's plain version on its default chunk against ``_fwd_lse_kernel``
    on blocks of that many keys (128 at d = 64, 32 at d = 512): the output and
    lane 0 of the TPU's 128-lane LSE; the wrapper's CPU route is the same
    call."""
    q, k, v = _qkv(rng, b, h, sq, skv, d)
    chunk = tsa.flash_online_chunk(skv, d)
    assert chunk == (128 if d == 64 else 32)
    jdt = getattr(jnp, dtype)
    o, lse = jfv._flash_forward_lse(*(jnp.asarray(x, jdt) for x in (q, k, v)), d ** -0.5, 64,
                                    chunk, True)
    t = [_t(x).to(getattr(torch, dtype)) for x in (q, k, v)]
    out, tlse = tfv.flash_fwd_lse_plain(*t, scale=d ** -0.5)
    wout, wlse = tfv.flash_fwd_lse(*t, scale=d ** -0.5)
    assert torch.equal(out, wout) and torch.equal(tlse, wlse)
    assert tlse.shape == (b, h, sq) and tlse.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(o), **TOL)
        np.testing.assert_allclose(tlse.numpy(), np.asarray(lse[..., 0]), atol=2e-4)
    else:
        max_abs, mean_abs = _bf16_err(out, o)
        assert mean_abs <= (1e-3 if d < 128 else 1e-5) and max_abs <= 8e-3, (max_abs, mean_abs)
        np.testing.assert_allclose(tlse.numpy(), np.asarray(lse[..., 0]),
                                   atol=2e-2 if d < 128 else 1e-3)


@pytest.mark.parametrize("skv,d,chunk", [
    (16384, 64, 128), (4096, 64, 128), (256, 64, 128), (384, 64, 128), (320, 64, 64),
    (192, 64, 64), (64, 64, 64), (4096, 512, 32), (256, 512, 32), (96, 512, 32), (16, 512, 16),
    (128, 16, 64), (32, 64, 32), (144, 64, 128), (200, 64, 128), (100, 64, 100), (36, 64, 36),
    (16, 64, 16), (9, 64, 9), (1, 64, 1),
])
def test_flash_online_chunk_rule(skv, d, chunk):
    """128 at d = 64 where it divides Skv, else 64 where that does, else 128
    over 64 keys with a ragged last chunk; 32 at d = 512 (the tile's keys);
    64 at every other width; Skv where that is shorter."""
    assert tsa.flash_online_chunk(skv, d) == chunk


def test_flash_chunk_rule_over_the_chip_shapes():
    """Every shape ``chip_smoke.py`` and ``scripts/torch_kernels.py`` give the
    two kernels takes 128 keys at d = 64 where 128 divides Skv, else 64, and
    32 at d = 512; the kernels take each such chunk and each such shape."""
    smoke = _module(ROOT / "chip_smoke.py")
    bench = _module(ROOT / "scripts" / "torch_kernels.py")
    shapes = ([(s, s, d) for _, s, d, _ in smoke.FLASH_SHAPES]
              + [(sq, skv, d) for _, sq, skv, d, _ in smoke.VJP_SHAPES]
              + [(sq, skv, 64) for _, _, sq, skv in smoke.FLASH_VARIANT_SHAPES]
              + [(sq, skv, 512) for _, _, sq, skv in [smoke.FLASH_VARIANT_D512]]
              + [(smoke.FLASH_CAPTURE_D512[2],) * 2 + (smoke.FLASH_CAPTURE_D512[3],)]
              + [(s, s, d) for _, s, d in bench.FLASH_SHAPES]
              + [(sq, skv, d) for _, sq, skv, d in bench.VJP_SHAPES]
              + [(sq, skv, d) for _, _, sq, skv, d in bench.FLASH_SMALL_SHAPES]
              + [(sq, skv, d) for _, _, sq, skv, d in bench.FLASH_SMALL_D512])
    assert {d for _, _, d in shapes} == {64, 512}
    seen = set()
    for sq, skv, d in shapes:
        chunk = tsa.flash_online_chunk(skv, d)
        want = min(skv, (128 if skv % 128 == 0 or skv % 64 and skv > 64 else 64)
                   if d == 64 else 32)
        assert chunk == want, (skv, d)
        tsa.check_flash_chunk("flash_fwd_lse", skv, d, chunk)
        assert tsa._flash_tiles_fit(sq, skv, d), (sq, skv, d)
        seen.add((d, chunk, sq == skv))
    # every chunk of the tiles is exercised, and Sq != Skv at both widths
    assert {(d, c) for d, c, _ in seen} >= {(64, 128), (64, 64), (512, 32)}
    assert {d for d, _, square in seen if not square} == {64, 512}


@pytest.mark.parametrize("skv,d,block_k", [(192, 64, 128), (256, 64, 32), (256, 512, 128),
                                           (256, 64, 256), (256, 512, 64), (96, 512, 64)])
def test_flash_fwd_lse_refuses_a_chunk_the_kernel_does_not_take(monkeypatch, skv, d, block_k):
    """On tensors made to look like the card's: a chunk the tile does not
    take raises ValueError before the kernel is loaded; a chunk it takes
    reaches the load (the fixture's refusal). 128 keys over 192 is such a
    chunk at d = 64: 128, then 64 in a masked tile."""
    monkeypatch.setattr(tsa, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))

    def meta(n):
        return torch.empty((1, 2, n, d), dtype=torch.bfloat16, device="meta")

    q, k = meta(64), meta(skv)
    if (skv, d, block_k) == (192, 64, 128):
        tsa.check_flash_chunk("flash_fwd_lse", skv, d, block_k)
        with pytest.raises(AssertionError, match="tried to load kernel flash_fwd_lse"):
            tfv.flash_fwd_lse(q, k, k, scale=0.125, block_k=block_k)
        return
    with pytest.raises(ValueError, match="key chunk"):
        tfv.flash_fwd_lse(q, k, k, scale=0.125, block_k=block_k)
    with pytest.raises(ValueError, match="key chunk"):
        tsa.check_flash_chunk("flash_fwd_lse", skv, d, block_k)
    with pytest.raises(AssertionError, match="tried to load kernel flash_fwd_lse"):
        tfv.flash_fwd_lse(q, k, k, scale=0.125, block_k=tsa.flash_online_chunk(skv, d))


@pytest.mark.parametrize("s,d,include_input", [(128, 64, False), (128, 64, True),
                                               (64, 64, False), (32, 8, True), (128, 8, False),
                                               (64, 512, False), (96, 512, True)])
def test_shared_forward_chunk_never_straddles_a_segment(rng, monkeypatch, s, d, include_input):
    """The widened forward of ``shared_flash_attention`` takes the shared
    kernels' chunk at d = 64 (``shared_online_chunk``), the d = 512 tile's 32
    keys at d = 512, and 64 keys (or the segment, where shorter) at other
    widths: a chunk that divides the segment length."""
    chunks = []
    real = tfv.flash_fwd_lse

    def record(*a, block_k=None, **kw):
        chunks.append(block_k)
        return real(*a, block_k=block_k, **kw)

    monkeypatch.setattr(tfv, "flash_fwd_lse", record)
    b, h, n = 1, 2, 3
    q, k_in, v_in = (_t(rng.normal(size=(b, h, s, d))).requires_grad_() for _ in range(3))
    rk, rv = (_t(rng.normal(size=(b, n, h, s, d))) for _ in range(2))
    out = tfv.shared_flash_attention(q, k_in, v_in, rk, rv, scale=d ** -0.5,
                                     include_input=include_input)
    out.sum().backward()
    want = (tsa.shared_online_chunk(s) if d == 64
            else tsa.D512_BLOCK_K if d == 512 else min(tsa.ONLINE_BLOCK_K, s))
    assert chunks == [want] and s % want == 0
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_default_chunk_follows_the_kernel_at_both_widths(rng):
    """The plain versions' default is the kernels' chunk: 128 at d = 64 (two
    chunks here, so the running max is taken twice), 32 at d = 512."""
    for d, chunk in ((64, 128), (512, 32)):
        q, k, v = (_bf16(x) for x in _qkv(rng, 1, 1, 64, 256, d))
        assert torch.equal(tsa.flash_online_plain(q, k, v, scale=d ** -0.5),
                           tsa.flash_online_plain(q, k, v, scale=d ** -0.5, block_k=chunk))
        for a, b_ in zip(tfv.flash_fwd_lse_plain(q, k, v, scale=d ** -0.5),
                         tfv.flash_fwd_lse_plain(q, k, v, scale=d ** -0.5, block_k=chunk)):
            assert torch.equal(a, b_)


@pytest.mark.parametrize("wrapper", ["flash_online", "flash_fwd_lse"])
@pytest.mark.parametrize("sq,skv", [(32, 64), (96, 64), (64, 48), (64, 80)])
def test_d512_wrappers_refuse_what_the_tile_does_not_take(monkeypatch, wrapper, sq, skv):
    """On tensors made to look like the card's, at d = 512: Sq not a multiple
    of 64 or Skv not a multiple of 32 raises ValueError before the kernel is
    loaded; a shape the tile takes (Sq != Skv) reaches the load (the
    fixture's refusal)."""
    monkeypatch.setattr(tsa, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))

    def meta(n):
        return torch.empty((2, 2, n, 512), dtype=torch.bfloat16, device="meta")

    def call(q, k):
        if wrapper == "flash_online":
            return tsa.flash_attention(q, k, k, scale=512 ** -0.5, algo="online")
        return tfv.flash_fwd_lse(q, k, k, scale=512 ** -0.5)

    with pytest.raises(ValueError, match="unsupported shapes"):
        call(meta(sq), meta(skv))
    with pytest.raises(AssertionError, match=f"tried to load kernel {wrapper}"):
        call(meta(192), meta(96))
