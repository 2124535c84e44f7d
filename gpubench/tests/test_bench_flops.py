"""The FLOP and byte counters against hand counts, and the attention bounds
against the bound column of the port's kernel table (PERF.md, Findings) at
the same shapes."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import flops
from gpubench.reference import model
from gpubench.tests.tiny import CONFIG, tiny_config

PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def _count(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def test_conv_linear_attention_against_hand_counts():
    meta = torch.device("meta")
    x = torch.empty(2, 8, 16, 16, device=meta)
    conv = {"weight": torch.empty(12, 8, 3, 3, device=meta), "bias": torch.empty(12, device=meta)}
    # 2 FLOPs a multiply-add: B * Cout * H * W * Cin * k * k
    assert _count(lambda: model.conv(conv, x)) == 2 * 2 * 12 * 16 * 16 * 8 * 9
    lin = {"weight": torch.empty(24, 40, device=meta), "bias": torch.empty(24, device=meta)}
    assert _count(lambda: model.linear(lin, torch.empty(3, 5, 40, device=meta))) == 2 * 15 * 40 * 24
    q = torch.empty(2, 4, 32, 16, device=meta)
    k = torch.empty(2, 4, 48, 16, device=meta)
    # q k^T and p v: 2 * 2 B H Sq Skv d
    assert _count(lambda: model.attend(q, k, k, 0.25, "self")) == 4 * 2 * 4 * 32 * 48 * 16


def test_restore_count_is_the_sum_of_its_parts():
    """A tiny warm restore's count equals its convs, linears and attention
    products counted one by one."""
    cfg = tiny_config()
    total = flops.model_flops(cfg, "warm")
    seen = []
    conv, linear, attend = model.conv, model.linear, model.attend

    def rec_conv(p, x, s=1.0, stride=1, padding=None):
        out = conv(p, x, s, stride, padding)
        cout, cin, kh, kw = p["weight"].shape
        seen.append(2 * out.numel() * cin * kh * kw)
        return out

    def rec_linear(p, x, s=1.0):
        out = linear(p, x, s)
        seen.append(2 * out.numel() * p["weight"].shape[1])
        return out

    def rec_attend(q, k, v, scale, kind):
        b, h, sq, d = q.shape
        seen.append(4 * b * h * sq * k.shape[2] * d)
        return attend(q, k, v, scale, kind)

    mp = pytest.MonkeyPatch()
    mp.setattr(model, "conv", rec_conv)
    mp.setattr(model, "linear", rec_linear)
    mp.setattr(model, "attend", rec_attend)
    block = _Collect(seen)
    try:
        flops._restore(cfg, "warm", 1, block)
    finally:
        mp.undo()
    assert block.collected and total == sum(block.collected)


class _Collect:
    """Keeps only what the block appends to ``seen``."""

    def __init__(self, seen):
        self.seen, self.collected = seen, []

    def __enter__(self):
        self.start = len(self.seen)

    def __exit__(self, *exc):
        self.collected = self.seen[self.start:]


def test_full_size_counts():
    cfg = json.loads(CONFIG.read_text())
    warm, cold = flops.model_flops(cfg, "warm"), flops.model_flops(cfg, "cold")
    assert 4.0e12 < warm < 5.5e12  # VAE encode and decode, one UNet, the shared keys
    assert 10e12 < cold < 14e12   # plus 4 references through the VAE encoder and the UNet
    calls = flops.attention_calls(cfg, "warm", 16)
    kinds = [c[0] for c in calls]
    assert (kinds.count("shared"), kinds.count("self"), kinds.count("vae")) == (9, 7, 2)
    calls = flops.attention_calls(cfg, "cold", 8)
    kinds = [c[0] for c in calls]
    assert (kinds.count("shared"), kinds.count("self"), kinds.count("vae")) == (9, 23, 3)


@pytest.mark.parametrize("call, rows, bound_ms", [
    # row 1 (warm, shared_identity), batch 16 with 10 distinct identities
    (("shared", (16, 20, 256, 64), (16, 20, 1024, 64)), 10, 0.022),
    (("shared", (16, 10, 1024, 64), (16, 10, 4096, 64)), 10, 0.174),
    (("shared", (16, 5, 4096, 64), (16, 5, 16384, 64)), 10, 1.390),
    # row 3 (cold, refs-only shared_flash_bound), batch 16
    (("shared", (16, 20, 256, 64), (16, 20, 1024, 64)), None, 0.032),
    # row 2 (flash_bound), batch 16
    (("self", (16, 5, 4096, 64), (16, 5, 4096, 64)), None, 0.347),
    (("self", (16, 10, 1024, 64), (16, 10, 1024, 64)), None, 0.043),
    (("self", (16, 20, 256, 64), (16, 20, 256, 64)), None, 0.013),
    (("self", (16, 20, 64, 64), (16, 20, 64, 64)), None, 0.003),
    (("vae", (16, 1, 4096, 512), (16, 1, 4096, 512)), None, 0.556),
])
def test_attention_bounds_match_the_kernel_table(call, rows, bound_ms):
    seconds, _, _ = flops.least_seconds(call, PEAKS, rows)
    assert round(seconds * 1e3, 3) == pytest.approx(bound_ms, abs=1.5e-3)
