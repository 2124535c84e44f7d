"""The GroupNorm kernel (``csrc/group_norm.cu``) against its plain version on
the card: every GroupNorm shape of a 512 px restore at batch 2 (the VAE's 4
channels a group at 128, the UNet's 10 / 20 / 40 and its concatenated
up-block inputs of 30, 60 and 80), with and without SiLU and the bias terms,
and at pixel counts that leave a ragged last block. Relative RMS at most
1e-2 (bf16 rounding of the plain path's coefficients and output alone gives
about 3e-3), and two launches bit for bit.

Needs an NVIDIA card: skips without one. This file imports no JAX, so it runs
without the repository's conftest there:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_group_norm_cuda.py``.
"""

import pytest
import torch

from instantrestore_tpu_torch.ops import primitives as prims

pytestmark = pytest.mark.cuda

# (H, W, C, act, bias terms) of the 512 px restore's GroupNorms: "c" is
# conv1's bias [C], "c+bc" it and the UNet's time-embedding term [B, C]
VAE_SHAPES = [
    (512, 512, 128, "silu", ""), (512, 512, 128, "silu", "c"), (256, 256, 128, "silu", ""),
    (256, 256, 256, "silu", ""), (256, 256, 256, "silu", "c"), (128, 128, 256, "silu", ""),
    (128, 128, 512, "silu", ""), (128, 128, 512, "silu", "c"), (64, 64, 512, "silu", ""),
    (64, 64, 512, "silu", "c"), (64, 64, 512, None, ""), (256, 256, 512, "silu", ""),
    (512, 512, 256, "silu", ""),
]
UNET_SHAPES = [
    (64, 64, 320, "silu", ""), (64, 64, 320, "silu", "c+bc"), (64, 64, 320, None, ""),
    (32, 32, 320, "silu", ""), (32, 32, 640, "silu", ""), (32, 32, 640, "silu", "c+bc"),
    (32, 32, 640, None, ""), (16, 16, 640, "silu", ""), (16, 16, 1280, "silu", ""),
    (16, 16, 1280, "silu", "c+bc"), (16, 16, 1280, None, ""), (8, 8, 1280, "silu", ""),
    (8, 8, 1280, "silu", "c+bc"), (8, 8, 1280, None, ""), (8, 8, 2560, "silu", ""),
    (16, 16, 2560, "silu", ""), (16, 16, 1920, "silu", ""), (32, 32, 1920, "silu", ""),
    (32, 32, 1280, "silu", ""), (32, 32, 960, "silu", ""), (64, 64, 960, "silu", ""),
    (64, 64, 640, "silu", ""),
]
# pixel counts that are no multiple of a block's rows, one pixel, and C = 8
RAGGED_SHAPES = [(7, 9, 320, "silu", "c+bc"), (3, 5, 1280, "silu", "c"), (1, 1, 640, None, ""),
                 (13, 11, 128, "silu", "c"), (5, 3, 2560, None, "c+bc"), (9, 9, 8, "silu", "c")]
REL_RMS_TOL = 1e-2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); the CPU tests hold the plain path")
    return torch.device("cuda")


def _case(card, batch, h, w, c, terms, groups=32, affine=torch.bfloat16):
    gen = torch.Generator(device=card).manual_seed(h * 7919 + w * 31 + c)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=card) * scale + shift)

    x = rnd(batch, h, w, c, scale=2.0, shift=0.5).to(torch.bfloat16)
    p = {"weight": rnd(c, shift=1.0).to(affine), "bias": rnd(c, scale=0.5).to(affine)}
    bias = ()
    if terms:
        bias = (rnd(c, scale=0.3).to(torch.bfloat16),)
    if terms == "c+bc":
        bias += (rnd(batch, c, scale=0.3).to(torch.bfloat16),)
    return x, p, bias, min(groups, c // 4) if c < 128 else groups


def _check(card, batch, h, w, c, act, terms, affine=torch.bfloat16):
    x, p, bias, groups = _case(card, batch, h, w, c, terms, affine=affine)
    with torch.no_grad():
        before = prims.group_norm.launches
        out = prims.group_norm(p, x, num_groups=groups, in_bias=bias, act=act)
        again = prims.group_norm(p, x, num_groups=groups, in_bias=bias, act=act)
        ref = prims.group_norm_plain(p, x, num_groups=groups, in_bias=bias, act=act)
    torch.cuda.synchronize()
    assert prims.group_norm.launches == before + 2
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert torch.isfinite(out).all()
    assert torch.equal(out, again), "two launches differ"
    o, r = out.float(), ref.float()
    rel = float((o - r).norm() / r.norm())
    assert rel <= REL_RMS_TOL, f"relative RMS {rel}"


@pytest.mark.parametrize("h, w, c, act, terms", VAE_SHAPES + UNET_SHAPES,
                         ids=lambda v: str(v))
def test_kernel_matches_plain_at_the_restore_shapes(card, h, w, c, act, terms):
    _check(card, 2, h, w, c, act, terms)


@pytest.mark.parametrize("h, w, c, act, terms", RAGGED_SHAPES, ids=lambda v: str(v))
def test_kernel_matches_plain_at_ragged_pixel_counts(card, h, w, c, act, terms):
    _check(card, 3, h, w, c, act, terms)


@pytest.mark.parametrize("batch", [1, 32])
def test_kernel_matches_plain_at_other_batches_and_fp32_affine(card, batch):
    """One row (the grid's most blocks a row) and the capture's batch 32;
    fp32 norm weights as an unconverted tree holds them."""
    _check(card, batch, 64, 64, 320, "silu", "c+bc", affine=torch.float32)


def test_kernel_raises_on_what_it_does_not_take(card):
    x = torch.zeros(2, 4, 4, 64, dtype=torch.bfloat16, device=card)
    p = {"weight": torch.ones(64, device=card), "bias": torch.zeros(64, device=card)}
    with pytest.raises(ValueError):
        prims.group_norm(p, x.permute(0, 2, 1, 3))  # not contiguous
    with pytest.raises(TypeError):
        prims.group_norm(p, x.half())
