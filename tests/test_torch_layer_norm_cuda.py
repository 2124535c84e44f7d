"""``ops/primitives.py::layer_norm`` on the card: a bf16 input that wants no
gradient runs ``F.layer_norm`` in bf16 (one launch), and gives bit for bit
what the fp32 round trip gives (``x.float()``, fp32 affine, the norm, cast
back), at every LayerNorm width of the port's UNets (320 / 640 / 1280, SD
-Turbo's and SDXL-Turbo's transformer blocks) and text and vision towers
(768 / 1024), at the token counts of a 512 px restore and a batch-32
capture, and at rows that are no multiple of a block.

Needs an NVIDIA card: skips without one. This file imports no JAX, so it runs
without the repository's conftest there:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_layer_norm_cuda.py``.
"""

import pytest
import torch
import torch.nn.functional as F

from instantrestore_tpu_torch.ops import primitives as prims

pytestmark = pytest.mark.cuda

# (rows, width): tokens x batch of the 512 px restore (batch 8) and capture
# (batch 32) at each UNet level, the towers' widths, ragged row counts
SHAPES = [(8 * 4096, 320), (32 * 4096, 320), (8 * 1024, 640), (32 * 1024, 640),
          (8 * 256, 1280), (32 * 256, 1280), (8 * 64, 1280), (2 * 77, 768), (2 * 77, 1024),
          (2 * 257, 1024), (7, 1280), (1, 640), (13, 320)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); the CPU tests hold the fp32 route")
    return torch.device("cuda")


def _fp32_round_trip(p, x, eps):
    y = F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(), p["bias"].float(), eps)
    return y.to(x.dtype)


@pytest.mark.parametrize("rows, width", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_bf16_layer_norm_is_the_fp32_round_trip_bit_for_bit(card, rows, width, eps):
    gen = torch.Generator(device=card).manual_seed(rows * 31 + width)
    x = (torch.randn(2, rows, width, generator=gen, device=card) * 3.0 + 0.7)[1]
    x = x.to(torch.bfloat16)
    p = {"weight": (torch.randn(width, generator=gen, device=card) + 1.0).to(torch.bfloat16),
         "bias": (torch.randn(width, generator=gen, device=card) * 0.5).to(torch.bfloat16)}
    with torch.no_grad():
        got = prims.layer_norm(p, x, eps=eps)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, _fp32_round_trip(p, x, eps))


def test_an_input_that_wants_a_gradient_takes_the_fp32_round_trip(card, monkeypatch):
    calls = []
    real = F.layer_norm
    monkeypatch.setattr(prims.F, "layer_norm", lambda x, *a: calls.append(x.dtype) or real(x, *a))
    p = {"weight": torch.ones(640, device=card, dtype=torch.bfloat16, requires_grad=True),
         "bias": torch.zeros(640, device=card, dtype=torch.bfloat16)}
    x = torch.randn(4, 640, device=card).to(torch.bfloat16)
    prims.layer_norm(p, x)
    with torch.no_grad():
        prims.layer_norm(p, x)
    assert calls == [torch.float32, torch.bfloat16]
