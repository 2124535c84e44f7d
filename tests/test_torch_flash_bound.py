"""The tile of ``flash_attention``'s bound kernel (row 2 of PERF.md's kernel
table) and its plain version.

At d = 64 the kernel runs on the plain layout of ``csrc/attn_wgmma.cuh``
(128 query rows a block where they divide Sq, else 64; a key chunk of 128
where it divides Skv, else 64, else a ragged last chunk; any Sq and Skv), at
d = 512 on ``csrc/attn_wgmma_d512.cuh`` (64 rows, 32 keys). One Python rule, ``flash_bound_chunk``, gives the chunk
to the C entry point and refuses before any launch what the tiles do not take
(the C launcher picks the rows). The bound softmax keeps no running max, so
the result depends on the chunk through fp32 summation order only: the same
function summed over the kernel's key chunks agrees with the plain version's
one product within 2e-5 in fp32. Its key-norm bound is taken in one pass over
the keys, the same norms as ``key_norm_max`` up to summation order.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from instantrestore_tpu_torch.ops import _build
from instantrestore_tpu_torch.ops import shared_attention as tsa

from test_torch_attention_kernels import TOL, _t

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def no_kernel_build(monkeypatch):
    """CPU tensors must never reach the CUDA build."""
    def refuse(name):
        raise AssertionError(f"CPU path tried to load kernel {name}")
    monkeypatch.setattr(_build, "load", refuse)
    tsa.reset_launch_counts()
    yield
    assert not any(fn.launches for fn in tsa.KERNEL_WRAPPERS)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sq,skv,d,chunk", [
    (4096, 4096, 64, 128), (1024, 1024, 64, 128), (256, 256, 64, 128), (64, 64, 64, 64),
    (192, 256, 64, 128), (256, 320, 64, 64),
    (4096, 4096, 512, 32), (128, 128, 512, 32), (64, 96, 512, 32),
])
def test_flash_bound_tile_rule(sq, skv, d, chunk):
    """d = 64: 128 keys where they divide Skv, else 64, the online kernels'
    chunk on the same layout. d = 512: 32 keys."""
    assert tsa.flash_bound_chunk(sq, skv, d) == chunk
    if d == 64:
        assert chunk == tsa.flash_online_chunk(skv, d)


@pytest.mark.parametrize("sq,skv,d", [
    (32, 64, 64), (64, 32, 64), (64, 96, 64), (0, 64, 64), (64, 64, 128), (64, 64, 16),
    (32, 4096, 512), (96, 128, 512), (64, 48, 512), (64, 0, 512),
])
def test_flash_bound_tile_refuses(sq, skv, d):
    """An empty side, another width, or at d = 512 Sq not a multiple of 64
    or Skv not of 32: no tile takes it. At d = 64 every Sq and Skv takes the
    tile, on the chunk of ``flash_online_chunk`` (here Skv 64: 64 keys; Skv
    32 or 96: all of them, in a masked tile of 64 or 128)."""
    if d == 64 and min(sq, skv) > 0:
        assert tsa.flash_bound_chunk(sq, skv, d) == min(skv, 64 if skv % 64 == 0 else 128)
        return
    with pytest.raises(ValueError, match="bound kernel takes"):
        tsa.flash_bound_chunk(sq, skv, d)


def test_flash_bound_tile_over_the_chip_shapes():
    """Every shape ``chip_smoke.py`` and ``scripts/torch_kernels.py`` give the
    bound kernel takes a tile, and between them they reach every tile: both
    row counts of the C launcher (128 where they divide Sq, else 64) and both
    chunks at d = 64, the one tile at d = 512."""
    smoke = _module(ROOT / "chip_smoke.py")
    bench = _module(ROOT / "scripts" / "torch_kernels.py")
    _, _, cs, cd = smoke.FLASH_CAPTURE_D512
    shapes = ([(s, s, d) for _, s, d, _ in smoke.FLASH_SHAPES]
              + [(sq, skv, 64) for _, _, sq, skv in smoke.FLASH_VARIANT_SHAPES]
              + [(cs, cs, cd)]
              + [(s, s, d) for _, s, d in bench.FLASH_SHAPES]
              + [(sq, skv, d) for _, _, sq, skv, d in bench.FLASH_SMALL_SHAPES])
    seen = {(d, 128 if d == 64 and sq % 128 == 0 and skv % tsa.key_tile(skv) == 0 else 64,
             tsa.flash_bound_chunk(sq, skv, d)) for sq, skv, d in shapes if skv % 64 == 0}
    assert seen == {(64, 128, 128), (64, 64, 128), (64, 128, 64), (64, 64, 64),
                    (512, 64, 32)}
    assert smoke.FLASH_CAPTURE_D512 == bench.FLASH_CAPTURE_D512 == (64, 1, 4096, 512)


def test_square_latents_fit_the_d512_tile():
    """The serving path's d = 512 attention runs over n x n latent tokens:
    wherever n^2 is a multiple of 32 (what the mma.sync tile took) it is a
    multiple of 64 too, so the tile's 64 query rows lose no shape, for the
    bound and the online kernels alike."""
    for n in range(1, 513):
        if n * n % 32 == 0:
            assert n * n % 64 == 0 and tsa.flash_bound_chunk(n * n, n * n, 512) == 32, n
            tsa.check_flash_chunk("flash_online", n * n, 512, tsa.flash_online_chunk(n * n, 512))


@pytest.mark.parametrize("sq,skv,d", [(32, 64, 64), (64, 96, 64), (96, 128, 512),
                                      (64, 48, 512), (64, 64, 128)])
def test_flash_attention_refuses_before_launch(monkeypatch, sq, skv, d):
    """On tensors made to look like the card's: a shape no tile takes raises
    ValueError before the kernel is loaded, for the bound and the online
    kernel alike (at both widths they run on the same tiles: Sq = 96 at d =
    512 no longer fits flash_online either); one that fits, every Sq and Skv
    at d = 64 among them, reaches the load (the fixture's refusal)."""
    monkeypatch.setattr(tsa, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))

    def meta(n, width=d):
        return torch.empty((1, 2, n, width), dtype=torch.bfloat16, device="meta")

    if d == 64:
        with pytest.raises(AssertionError, match="tried to load kernel flash_bound"):
            tsa.flash_attention(meta(sq), meta(skv), meta(skv), scale=0.125, algo="bound")
        with pytest.raises(AssertionError, match="tried to load kernel flash_online"):
            tsa.flash_attention(meta(sq), meta(skv), meta(skv), scale=0.125, algo="online")
    else:
        with pytest.raises(ValueError, match="flash_attention: unsupported shapes"):
            tsa.flash_attention(meta(sq), meta(skv), meta(skv), scale=0.125, algo="bound")
        with pytest.raises(ValueError, match="flash_online: unsupported shapes"):
            tsa.flash_attention(meta(sq), meta(skv), meta(skv), scale=0.125, algo="online")
    with pytest.raises(AssertionError, match="tried to load kernel flash_bound"):
        tsa.flash_attention(meta(64, 64), meta(128, 64), meta(128, 64), scale=0.125,
                            algo="bound")
    with pytest.raises(AssertionError, match="tried to load kernel flash_online"):
        tsa.flash_attention(meta(64, 512), meta(96, 512), meta(96, 512), scale=0.125,
                            algo="online")


def _bound_plain_chunked(q, k, v, scale, chunk):
    """``flash_attention_plain``'s function with the keys summed in chunks of
    ``chunk``, in order, as the kernel sums them."""
    kmax = tsa._key_norm_max_one_pass(k, 2)[:, :, None, None]
    bound = tsa._row_norm(q) * (scale * tsa.LOG2E) * kmax - tsa.BOUND_EXP_SHIFT
    qs = tsa._q_scaled(q, scale).float()
    acc, l = 0, 0
    for j in range(0, k.shape[2], chunk):
        p = torch.exp2(qs @ k[:, :, j : j + chunk].float().transpose(-1, -2) - bound)
        pr = p.to(v.dtype).float()
        acc = acc + pr @ v[:, :, j : j + chunk].float()
        l = l + pr.sum(-1, keepdim=True)
    return (acc / l).to(q.dtype)


@pytest.mark.parametrize("b,h,sq,skv,d,chunks", [
    (2, 2, 64, 256, 64, (64, 128)), (1, 3, 128, 192, 64, (64,)), (2, 1, 64, 128, 512, (32, 64)),
])
def test_flash_bound_plain_is_independent_of_the_chunk(rng, b, h, sq, skv, d, chunks):
    """fp32: the bound function summed over key chunks of the kernel's sizes
    agrees with the plain version's one product within 2e-5 (no running max:
    only the order of the fp32 sums moves), and the wrapper's CPU route is
    the plain version."""
    q, k, v = (_t(rng.normal(size=(b, h, n, d))) for n in (sq, skv, skv))
    scale = d ** -0.5
    whole = tsa.flash_attention_plain(q, k, v, scale=scale)
    assert torch.equal(whole, tsa.flash_attention(q, k, v, scale=scale, algo="bound"))
    assert torch.equal(whole, _bound_plain_chunked(q, k, v, scale, skv))
    for chunk in chunks:
        np.testing.assert_allclose(_bound_plain_chunked(q, k, v, scale, chunk).numpy(),
                                   whole.numpy(), **TOL)


def test_flash_bound_plain_takes_kmax_in_one_pass(rng, monkeypatch):
    """The plain version's kmax is the one-pass norm (no fp32 copies of the
    keys), equal to ``key_norm_max`` up to fp32 summation order."""
    k = _t(rng.normal(size=(2, 3, 96, 512)) * 4)
    np.testing.assert_allclose(tsa._key_norm_max_one_pass(k, 2).numpy(),
                               tsa.key_norm_max(k, 2).numpy(), rtol=1e-6)
    calls = []
    real = tsa._key_norm_max_one_pass

    def record(keys, dims):
        calls.append(tuple(keys.shape))
        return real(keys, dims)

    monkeypatch.setattr(tsa, "_key_norm_max_one_pass", record)
    monkeypatch.setattr(tsa, "key_norm_max", None)  # the three-copy reduction is not called
    q = _t(rng.normal(size=(2, 3, 32, 512)))
    tsa.flash_attention_plain(q, k, k, scale=512 ** -0.5)
    assert calls == [(2, 3, 96, 512)]
