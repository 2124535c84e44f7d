"""The key chunk of the running max of ``flash_online`` and ``flash_fwd_lse``
(rows 8 and 4 of PERF.md's kernel table).

At d = 64 both kernels run on the wgmma tile of ``csrc/attn_wgmma.cuh``,
whose chunk is 128 keys where 128 divides Skv and 64 otherwise; at d = 512
they keep the 64-key chunk of ``csrc/attn_tile.cuh``. The result depends on
the chunk at bf16 rounding level, so one Python rule (``flash_online_chunk``)
gives the chunk to the kernels and to their plain versions. Here: the plain
versions on their default chunk against the Pallas kernels in interpret mode
on the same chunk (fp32 to 2e-5, the LSE to 2e-4 as in
``tests/test_torch_flash_vjp.py``; bf16 to mean-abs 1e-3, XLA-CPU's bf16 exp2
as in ``tests/test_torch_online_attention.py``), the rule over every shape
``chip_smoke.py`` and ``scripts/torch_kernels.py`` launch, the chunk of the
widened shared forward, and the wrapper's refusal of a chunk the kernel does
not take, before any launch.
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
# (B, H, Sq, Skv, d): two and three 128-key chunks
SHAPES = [(1, 2, 64, 256, 64), (1, 2, 128, 384, 64)]


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
    """Row 8's plain version on its default chunk (128 keys here) against
    ``_flash_kernel`` on 128-key blocks; the wrapper's CPU route is the same
    call."""
    q, k, v = _qkv(rng, b, h, sq, skv, d)
    jdt = getattr(jnp, dtype)
    ref = jsa.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), scale=d ** -0.5,
                              block_q=64, block_k=128, interpret=True, algo="online")
    t = [_t(x).to(getattr(torch, dtype)) for x in (q, k, v)]
    out = tsa.flash_online_plain(*t, scale=d ** -0.5)
    assert torch.equal(out, tsa.flash_online_plain(*t, scale=d ** -0.5, block_k=128))
    assert torch.equal(out, tsa.flash_attention(*t, scale=d ** -0.5, algo="online"))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    else:
        max_abs, mean_abs = _bf16_err(out, ref)
        assert mean_abs <= 1e-3 and max_abs <= 8e-3, (max_abs, mean_abs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES)
def test_flash_fwd_lse_default_chunk_matches_pallas(rng, b, h, sq, skv, d, dtype):
    """Row 4's plain version on its default chunk against ``_fwd_lse_kernel``
    on 128-key blocks: the output and lane 0 of the TPU's 128-lane LSE; the
    wrapper's CPU route is the same call."""
    q, k, v = _qkv(rng, b, h, sq, skv, d)
    jdt = getattr(jnp, dtype)
    o, lse = jfv._flash_forward_lse(*(jnp.asarray(x, jdt) for x in (q, k, v)), d ** -0.5, 64,
                                    128, True)
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
        assert mean_abs <= 1e-3 and max_abs <= 8e-3, (max_abs, mean_abs)
        np.testing.assert_allclose(tlse.numpy(), np.asarray(lse[..., 0]), atol=2e-2)


@pytest.mark.parametrize("skv,d,chunk", [
    (16384, 64, 128), (4096, 64, 128), (256, 64, 128), (384, 64, 128), (320, 64, 64),
    (192, 64, 64), (64, 64, 64), (4096, 512, 64), (256, 512, 64), (128, 16, 64), (32, 64, 32),
])
def test_flash_online_chunk_rule(skv, d, chunk):
    """128 at d = 64 where it divides Skv, else 64; 64 at every other width;
    Skv where that is shorter (the plain versions only)."""
    assert tsa.flash_online_chunk(skv, d) == chunk


def test_flash_chunk_rule_over_the_chip_shapes():
    """Every shape ``chip_smoke.py`` and ``scripts/torch_kernels.py`` give the
    two kernels takes 128 keys at d = 64 where 128 divides Skv, else 64, and
    64 at d = 512; the kernels take each such chunk."""
    smoke = _module(ROOT / "chip_smoke.py")
    bench = _module(ROOT / "scripts" / "torch_kernels.py")
    shapes = ([(s, d) for _, s, d, _ in smoke.FLASH_SHAPES]
              + [(skv, d) for _, _, skv, d, _ in smoke.VJP_SHAPES]
              + [(skv, 64) for _, _, _, skv in smoke.FLASH_VARIANT_SHAPES]
              + [(s, d) for _, s, d in bench.FLASH_SHAPES]
              + [(skv, d) for _, _, skv, d in bench.VJP_SHAPES]
              + [(skv, d) for _, _, _, skv, d in bench.FLASH_SMALL_SHAPES])
    assert {d for _, d in shapes} == {64, 512}
    seen = set()
    for skv, d in shapes:
        chunk = tsa.flash_online_chunk(skv, d)
        assert chunk == (128 if d == 64 and skv % 128 == 0 else 64), (skv, d)
        tsa.check_flash_chunk("flash_fwd_lse", skv, d, chunk)
        seen.add((d, chunk))
    assert seen == {(64, 128), (64, 64), (512, 64)}  # every chunk of the tiles is exercised


@pytest.mark.parametrize("skv,d,block_k", [(192, 64, 128), (256, 64, 32), (256, 512, 128),
                                           (256, 64, 256)])
def test_flash_fwd_lse_refuses_a_chunk_the_kernel_does_not_take(monkeypatch, skv, d, block_k):
    """On tensors made to look like the card's: a chunk the tile does not
    take raises ValueError before the kernel is loaded; a chunk it takes
    reaches the load (the fixture's refusal)."""
    monkeypatch.setattr(tsa, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))

    def meta(n):
        return torch.empty((1, 2, n, d), dtype=torch.bfloat16, device="meta")

    q, k = meta(64), meta(skv)
    with pytest.raises(ValueError, match="key chunk"):
        tfv.flash_fwd_lse(q, k, k, scale=0.125, block_k=block_k)
    with pytest.raises(ValueError, match="key chunk"):
        tsa.check_flash_chunk("flash_fwd_lse", skv, d, block_k)
    with pytest.raises(AssertionError, match="tried to load kernel flash_fwd_lse"):
        tfv.flash_fwd_lse(q, k, k, scale=0.125, block_k=tsa.flash_online_chunk(skv, d))


@pytest.mark.parametrize("s,d,include_input", [(128, 64, False), (128, 64, True),
                                               (64, 64, False), (32, 8, True), (128, 8, False)])
def test_shared_forward_chunk_never_straddles_a_segment(rng, monkeypatch, s, d, include_input):
    """The widened forward of ``shared_flash_attention`` takes the shared
    kernels' chunk at d = 64 (``shared_online_chunk``) and 64 keys (or the
    segment, where shorter) at other widths: a chunk that divides the
    segment length."""
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
    want = tsa.shared_online_chunk(s) if d == 64 else min(tsa.ONLINE_BLOCK_K, s)
    assert chunks == [want] and s % want == 0
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_default_chunk_follows_the_kernel_at_both_widths(rng):
    """The plain versions' default is the kernels' chunk: 128 at d = 64 (two
    chunks here, so the running max is taken twice), 64 at d = 512."""
    for d, chunk in ((64, 128), (512, 64)):
        q, k, v = (_bf16(x) for x in _qkv(rng, 1, 1, 64, 256, d))
        assert torch.equal(tsa.flash_online_plain(q, k, v, scale=d ** -0.5),
                           tsa.flash_online_plain(q, k, v, scale=d ** -0.5, block_k=chunk))
        for a, b_ in zip(tfv.flash_fwd_lse_plain(q, k, v, scale=d ** -0.5),
                         tfv.flash_fwd_lse_plain(q, k, v, scale=d ** -0.5, block_k=chunk)):
            assert torch.equal(a, b_)
