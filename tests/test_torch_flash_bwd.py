"""The tiles of the backward kernels (rows 5 and 6 of PERF.md's kernel table,
``flash_bwd_dq`` and ``flash_bwd_dkv``) and their plain versions.

At d = 64 both kernels run on the wgmma + TMA tile of
``csrc/attn_wgmma_bwd.cuh`` (128 rows a block where they divide the block's
side, else 64; 64-row chunks; any Sq and Skv), at d = 512 on that of
``csrc/attn_wgmma_bwd_d512.cuh`` (64 rows a block, 16-row chunks; the d = 512
forward's shapes). One Python rule, ``flash_bwd_tiles``, gives both C entry
points their tiles and refuses before any launch what the tiles do not take. The backward keeps no
running max, so the result depends on the chunk through fp32 summation order
only: the plain versions summed in the tile's chunks agree with their default
chunks within 2e-5 in fp32, and with the Pallas kernels in interpret mode at
a shape that takes the 64-row tile within the tolerance of
``tests/test_torch_flash_vjp.py::test_backward_plain_matches_pallas``.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.ops import flash_vjp as jfv
from instantrestore_tpu_torch.ops import flash_vjp as tfv
from instantrestore_tpu_torch.ops import shared_attention as tsa

from test_torch_attention_kernels import TOL, _t
from test_torch_flash_vjp import no_kernel_build  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _module(ROOT / "chip_smoke.py")
BENCH = _module(ROOT / "scripts" / "torch_kernels.py")
# (Sq, Skv, d) of every backward launch of a train step, and of the variant shapes
TRAIN_SHAPES = [(sq, skv, d) for _, sq, skv, d, _ in SMOKE.VJP_SHAPES]
VARIANT_SHAPES = [(sq, skv, 64) for _, _, sq, skv in SMOKE.FLASH_VARIANT_SHAPES]


def _expected(sq, skv, d):
    if d == 512:
        return (64, 16, 64, 16)
    return (128 if sq % 128 == 0 and skv % 64 == 0 else 64, 64,
            128 if skv % 128 == 0 else 64, 64)


@pytest.mark.parametrize("sq,skv,d", TRAIN_SHAPES + VARIANT_SHAPES,
                         ids=lambda x: str(x))
def test_flash_bwd_tile_rule(sq, skv, d):
    """Every shape of a train step and every variant shape takes a tile:
    at d = 64 128 rows a block where they divide the side the block owns
    (queries for dQ, keys for dK/dV), else 64, and 64-row chunks; at d = 512
    64 rows a block and 16-row chunks."""
    tiles = tfv.flash_bwd_tiles(sq, skv, d)
    assert tuple(tiles) == _expected(sq, skv, d)
    assert sq % tiles.dq_rows == 0 and skv % tiles.dq_chunk == 0
    assert skv % tiles.dkv_rows == 0 and sq % tiles.dkv_chunk == 0


def test_train_step_shapes_at_d64():
    """The train-step shapes at d = 64 are Sq in {4096, 1024, 256, 64} against
    Skv in {16384, 4096, 1024, 256, 64}; (64, 64) takes the 64-row, 64-key
    tile of both kernels."""
    d64 = [(sq, skv) for sq, skv, d in TRAIN_SHAPES if d == 64]
    assert {sq for sq, _ in d64} == {4096, 1024, 256, 64}
    assert {skv for _, skv in d64} == {16384, 4096, 1024, 256, 64}
    assert tuple(tfv.flash_bwd_tiles(64, 64, 64)) == (64, 64, 64, 64)


def test_flash_bwd_tiles_over_the_chip_shapes():
    """Between them, ``chip_smoke.py`` and ``scripts/torch_kernels.py``
    (512 px and ``--small`` cases) reach every tile of both kernels: one and
    two consumer warpgroups of each at d = 64, and the d = 512 tile."""
    shapes = (TRAIN_SHAPES + VARIANT_SHAPES
              + [(sq, skv, d) for _, sq, skv, d in BENCH.VJP_SHAPES]
              + [(sq, skv, d) for _, _, sq, skv, d in BENCH.FLASH_SMALL_SHAPES])
    dq = {(d, tfv.flash_bwd_tiles(sq, skv, d).dq_rows) for sq, skv, d in shapes}
    dkv = {(d, tfv.flash_bwd_tiles(sq, skv, d).dkv_rows) for sq, skv, d in shapes}
    assert dq == dkv == {(64, 64), (64, 128), (512, 64)}
    small = {(sq, skv, d) for _, _, sq, skv, d in BENCH.FLASH_SMALL_SHAPES}
    assert set(VARIANT_SHAPES) <= small


@pytest.mark.parametrize("sq,skv,d", [
    (32, 64, 64), (64, 32, 64), (64, 96, 64), (96, 64, 64), (0, 64, 64), (64, 0, 64),
    (64, 64, 128), (64, 64, 16), (16, 64, 512), (32, 32, 512), (32, 0, 512),
])
def test_flash_bwd_tiles_refuse(sq, skv, d):
    """An empty side, another width, or at d = 512 a shape the forward does
    not take (Sq off 64, Skv off 32): no tile. At d = 64 Sq and Skv off the
    64-row chunk take the tiles (the ragged ends are masked or padded), 64
    rows a block."""
    if d == 64 and min(sq, skv) > 0:
        assert tuple(tfv.flash_bwd_tiles(sq, skv, d)) == (64, 64, 64, 64)
        return
    with pytest.raises(ValueError, match="backward kernels take"):
        tfv.flash_bwd_tiles(sq, skv, d)


@pytest.mark.parametrize("name", ["flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("sq,skv,d", [(32, 64, 64), (64, 96, 64), (64, 64, 128),
                                      (32, 32, 512)])
def test_backward_refuses_before_launch(monkeypatch, name, sq, skv, d):
    """On tensors made to look like the card's: a shape no tile takes raises
    ValueError before the kernel is loaded; one that fits (at d = 64 any Sq
    and Skv, their lse2 and delta padded to the tile's 64 rows) reaches the
    load (the fixture's refusal)."""
    monkeypatch.setattr(tsa, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    wrapper = getattr(tfv, name)

    def args(sq_, skv_, d_):
        """q, k, v, dO, lse, delta on the meta device."""
        q, k, v, do = (torch.empty((1, 2, n, d_), dtype=torch.bfloat16, device="meta")
                       for n in (sq_, skv_, skv_, sq_))
        lse = torch.empty((1, 2, sq_), dtype=torch.float32, device="meta")
        return q, k, v, do, lse, lse

    if d == 64:
        with pytest.raises(AssertionError, match=f"tried to load kernel {name}"):
            wrapper(*args(sq, skv, d), scale=0.125)
    else:
        with pytest.raises(ValueError, match=f"{name}: unsupported shapes"):
            wrapper(*args(sq, skv, d), scale=0.125)
    with pytest.raises(AssertionError, match=f"tried to load kernel {name}"):
        wrapper(*args(64, 128, 64), scale=0.125)


def _grads_inputs(rng, b, h, sq, skv, d):
    q, k, v, do = (_t(rng.normal(size=(b, h, n, d))) for n in (sq, skv, skv, sq))
    scale = d ** -0.5
    out, lse = tfv.flash_fwd_lse_plain(q, k, v, scale=scale)
    delta = (do * out).sum(-1)
    return (q, k, v, do, lse, delta), scale


@pytest.mark.parametrize("b,h,sq,skv,d", [
    (2, 2, 128, 192, 64), (1, 3, 192, 256, 64), (2, 1, 64, 64, 64), (1, 1, 64, 128, 512),
])
def test_plain_in_the_tile_chunks_matches_default(rng, b, h, sq, skv, d):
    """fp32: the plain versions summed over the tile's chunks (keys for dQ,
    queries for dK/dV, in order) agree with their default chunks within
    2e-5, and the wrappers' CPU route is the default plain version."""
    args, scale = _grads_inputs(rng, b, h, sq, skv, d)
    tiles = tfv.flash_bwd_tiles(sq, skv, d)
    dq = tfv.flash_bwd_dq_plain(*args, scale=scale)
    dk, dv = tfv.flash_bwd_dkv_plain(*args, scale=scale)
    assert torch.equal(dq, tfv.flash_bwd_dq(*args, scale=scale))
    got_k, got_v = tfv.flash_bwd_dkv(*args, scale=scale)
    assert torch.equal(dk, got_k) and torch.equal(dv, got_v)
    np.testing.assert_allclose(
        tfv.flash_bwd_dq_plain(*args, scale=scale, block_k=tiles.dq_chunk).numpy(), dq.numpy(),
        **TOL)
    tk, tv = tfv.flash_bwd_dkv_plain(*args, scale=scale, block_q=tiles.dkv_chunk)
    np.testing.assert_allclose(tk.numpy(), dk.numpy(), **TOL)
    np.testing.assert_allclose(tv.numpy(), dv.numpy(), **TOL)


@pytest.mark.parametrize("b,h,sq,skv", [(1, 2, 64, 128), (1, 1, 192, 256)])
def test_backward_plain_matches_pallas_at_the_tile(rng, b, h, sq, skv):
    """d = 64 at shapes of the 64-row tile (a 64-row block of dQ, 64 or 128
    keys a block of dK/dV): the plain backward on the tile's chunks against
    ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` in interpret mode on the
    same chunk, on JAX's own residuals, fp32, 5e-5."""
    d = 64
    q, k, v, ct = (rng.normal(size=(b, h, n, d)).astype(np.float32) for n in (sq, skv, skv, sq))
    scale = d ** -0.5
    tiles = tfv.flash_bwd_tiles(sq, skv, d)
    assert tiles.dq_rows == 64
    chunk = tiles.dq_chunk
    qj, kj, vj, cj = (jnp.asarray(x) for x in (q, k, v, ct))
    o, lse = jfv._flash_forward_lse(qj, kj, vj, scale, chunk, chunk, True)
    dq, dk, dv = jfv._flash_backward(qj, kj, vj, o, lse, cj, scale, chunk, chunk, True)
    delta = (_t(ct) * _t(o)).sum(-1)
    args = (_t(q), _t(k), _t(v), _t(ct), _t(lse[..., 0]), delta)
    np.testing.assert_allclose(
        tfv.flash_bwd_dq_plain(*args, scale=scale, block_k=chunk).numpy(), np.asarray(dq),
        atol=5e-5)
    tdk, tdv = tfv.flash_bwd_dkv_plain(*args, scale=scale, block_q=tiles.dkv_chunk)
    np.testing.assert_allclose(tdk.numpy(), np.asarray(dk), atol=5e-5)
    np.testing.assert_allclose(tdv.numpy(), np.asarray(dv), atol=5e-5)


@pytest.mark.parametrize("scale", [0.125, 64 ** -0.5, 0.3])
def test_backward_qs_is_the_forwards_scaled_q(rng, scale):
    """The scaled q that the wrappers hand both tiles (the constant rounded
    on the host) has the bits of ``_q_scaled``, the forward's, at d = 64 and
    at d = 512."""
    for d in (64, 512):
        q = torch.from_numpy(rng.normal(size=(2, 3, 64, d)) * 5).to(torch.bfloat16)
        assert torch.equal(tfv._backward_qs(q, scale), tsa._q_scaled(q, scale))
