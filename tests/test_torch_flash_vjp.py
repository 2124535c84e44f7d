"""The port's differentiable attention (``ops/flash_vjp.py``) vs the JAX
package's (``instantrestore_tpu/ops/flash_vjp.py``): the three plain versions
against the Pallas kernels ``_fwd_lse_kernel``, ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` in interpret mode, the autograd wrappers against
``jax.grad`` of the custom-VJP wrappers, the attention module's fused branch
and ``segment_softmax_sums``.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels are held against those same plain versions on the card by
chip_smoke.py). fp32 tolerances are those of ``tests/test_flash_vjp.py``: out
2e-5, LSE 2e-4, gradients 5e-5 per kernel and 1e-4 through the wrappers
(fp32 summation order). The bf16 cases state their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.models import attention as jattn
from instantrestore_tpu.ops import flash_vjp as jfv
from instantrestore_tpu.ops import shared_attention as jsa
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.models import attention as tattn
from instantrestore_tpu_torch.ops import _build
from instantrestore_tpu_torch.ops import flash_vjp as tfv
from instantrestore_tpu_torch.ops import shared_attention as tsa

from test_torch_attention_kernels import _bf16, _shared_inputs, _t, record_calls

BLOCK = 32  # JAX's block_q / block_k here, and the plain versions' key chunk


@pytest.fixture(autouse=True)
def no_kernel_build(monkeypatch):
    """CPU tensors must never reach the CUDA build."""
    def refuse(name):
        raise AssertionError(f"CPU path tried to load kernel {name}")
    monkeypatch.setattr(_build, "load", refuse)
    tfv.reset_launch_counts()
    yield
    assert not any(fn.launches for fn in tfv.KERNEL_WRAPPERS)


def test_nine_kernel_wrappers():
    names = [fn.__name__ for fn in tfv.KERNEL_WRAPPERS]
    assert len(names) == len(set(names)) == 9
    assert names[-3:] == ["flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"]
    assert all(hasattr(tfv, n + "_plain") for n in names[-3:])


def _qkv(rng, b, h, sq, skv, d):
    return [rng.normal(size=(b, h, n, d)).astype(np.float32) for n in (sq, skv, skv, sq)]


def _jax_forward_backward(q, k, v, ct, scale, dtype):
    qj, kj, vj, cj = (jnp.asarray(x, dtype) for x in (q, k, v, ct))
    o, lse = jfv._flash_forward_lse(qj, kj, vj, scale, BLOCK, BLOCK, True)
    grads = jfv._flash_backward(qj, kj, vj, o, lse, cj, scale, BLOCK, BLOCK, True)
    return o, lse, grads


# d=8: the rounded-argument branch with the row sum on the matrix unit;
# d=256 and d=512: fp32 p and a separate row sum
SHAPES = [(1, 2, 64, 128, 8), (2, 1, 64, 64, 256), (1, 1, 32, 64, 512)]


@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES)
def test_fwd_lse_plain_matches_pallas(rng, b, h, sq, skv, d):
    q, k, v, ct = _qkv(rng, b, h, sq, skv, d)
    scale = d ** -0.5
    o, lse, _ = _jax_forward_backward(q, k, v, ct, scale, jnp.float32)
    out, tlse = tfv.flash_fwd_lse_plain(_t(q), _t(k), _t(v), scale=scale, block_k=BLOCK)
    np.testing.assert_allclose(out.numpy(), np.asarray(o), atol=2e-5)
    # the TPU kernel broadcasts the row's value over 128 lanes; the port keeps one
    assert tlse.shape == (b, h, sq) and tlse.dtype == torch.float32
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse[..., 0]), atol=2e-4)
    np.testing.assert_allclose(np.asarray(lse[..., 0]), np.asarray(lse[..., 127]))


@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES)
def test_backward_plain_matches_pallas(rng, b, h, sq, skv, d):
    """The backward kernels' plain versions on JAX's own residuals (out and
    lane 0 of the LSE), fp32."""
    q, k, v, ct = _qkv(rng, b, h, sq, skv, d)
    scale = d ** -0.5
    o, lse, (dq, dk, dv) = _jax_forward_backward(q, k, v, ct, scale, jnp.float32)
    tl = _t(lse[..., 0])
    delta = (_t(ct) * _t(o)).sum(-1)
    args = (_t(q), _t(k), _t(v), _t(ct), tl, delta)
    np.testing.assert_allclose(tfv.flash_bwd_dq_plain(*args, scale=scale, block_k=BLOCK).numpy(),
                               np.asarray(dq), atol=5e-5)
    tdk, tdv = tfv.flash_bwd_dkv_plain(*args, scale=scale, block_q=BLOCK)
    np.testing.assert_allclose(tdk.numpy(), np.asarray(dk), atol=5e-5)
    np.testing.assert_allclose(tdv.numpy(), np.asarray(dv), atol=5e-5)
    # the default chunks (what bounds the score block) only reorder the fp32 sum
    np.testing.assert_allclose(tfv.flash_bwd_dq_plain(*args, scale=scale).numpy(), np.asarray(dq),
                               atol=5e-5)
    np.testing.assert_allclose(tfv.flash_bwd_dkv_plain(*args, scale=scale)[0].numpy(),
                               np.asarray(dk), atol=5e-5)


@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES)
def test_kernels_bf16_match_pallas(rng, b, h, sq, skv, d):
    """bf16 on JAX's chunk. Forward: at d=8 XLA's CPU ``exp2`` of a bf16
    argument is inexact (it multiplies by ln 2 in bf16 first), which sets the
    tolerance as for the online serving kernels (mean-abs 1e-3 of an O(1)
    output); at d >= 128 p stays fp32 and the two agree to bf16 rounding.
    Backward, on JAX's residuals: P is fp32 in both, so what differs is the
    summation order before each bf16 rounding: mean-abs 2e-3 of O(1)
    gradients, max-abs within two bf16 ulps of the largest value."""
    q, k, v, ct = _qkv(rng, b, h, sq, skv, d)
    scale = d ** -0.5
    o, lse, grads = _jax_forward_backward(q, k, v, ct, scale, jnp.bfloat16)
    out, tlse = tfv.flash_fwd_lse_plain(_bf16(q), _bf16(k), _bf16(v), scale=scale, block_k=BLOCK)
    assert out.dtype == torch.bfloat16 and tlse.dtype == torch.float32
    err = np.abs(out.float().numpy() - np.asarray(o.astype(jnp.float32)))
    assert err.mean() <= (1e-3 if d < 128 else 2e-4), err.mean()
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse[..., 0]), atol=2e-2 if d < 128 else 1e-3)

    to = torch.from_numpy(np.asarray(o.astype(jnp.float32))).to(torch.bfloat16)
    delta = (_bf16(ct).float() * to.float()).sum(-1)
    args = (_bf16(q), _bf16(k), _bf16(v), _bf16(ct), _t(lse[..., 0]), delta)
    mine = (tfv.flash_bwd_dq_plain(*args, scale=scale, block_k=BLOCK),
            *tfv.flash_bwd_dkv_plain(*args, scale=scale, block_q=BLOCK))
    for name, got, ref in zip(("dq", "dk", "dv"), mine, grads):
        assert got.dtype == torch.bfloat16
        r = np.asarray(ref.astype(jnp.float32))
        err = np.abs(got.float().numpy() - r)
        assert err.mean() <= 2e-3 and err.max() <= 2 ** -6 * max(1.0, np.abs(r).max()), (
            name, err.mean(), err.max())


@pytest.mark.parametrize("d", [8, 256])
def test_flash_attention_grads_match_jax(rng, d):
    q, k, v, ct = _qkv(rng, 1, 2, 64, 128, d)
    scale = d ** -0.5

    def loss(q_, k_, v_):
        o = jfv.flash_attention(q_, k_, v_, scale=scale, block_q=BLOCK, block_k=BLOCK,
                                interpret=True)
        return jnp.sum(o * jnp.asarray(ct))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    # a permuted cotangent: the wrapper makes dO's layout explicit
    out = tfv.flash_attention(tq, tk, tv, scale=scale)
    cot = _t(ct).transpose(1, 2).contiguous().transpose(1, 2)
    assert not cot.is_contiguous()
    got = torch.autograd.grad(out, (tq, tk, tv), cot)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, err_msg=f"d{name}")
    # and autograd through the port's own unfused attention
    own = torch.autograd.grad(tattn.softmax_attention(tq, tk, tv, scale), (tq, tk, tv), _t(ct))
    for name, g, r in zip("qkv", got, own):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("include_input", [True, False])
@pytest.mark.parametrize("use_adain", [True, False])
def test_shared_grads_match_jax(rng, include_input, use_adain):
    """Gradients for q, k_in, v_in, ref_k, ref_v (v_in also through the AdaIN
    affine) against jax.grad of the custom-VJP wrapper, and against autograd
    through the port's softmax_attention + widen_kv."""
    b, h, s, d, n = 1, 2, 32, 8, 2
    xs = [rng.normal(size=shape).astype(np.float32)
          for shape in [(b, h, s, d)] * 3 + [(b, n, h, s, d)] * 2]
    ct = rng.normal(size=(b, h, s, d)).astype(np.float32)
    scale = d ** -0.5

    def jloss(q, k_in, v_in, rk, rv):
        affine = jsa.adain_affine(v_in, rv) if use_adain else None
        o = jfv.shared_flash_attention(q, k_in, v_in, rk, rv, scale=scale, v_affine=affine,
                                       include_input=include_input, interpret=True)
        return jnp.sum(o * jnp.asarray(ct))

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(x) for x in xs))
    ts = [_t(x).requires_grad_() for x in xs]
    q, k_in, v_in, rk, rv = ts
    affine = tfv.adain_affine(v_in, rv) if use_adain else None
    out = tfv.shared_flash_attention(q, k_in, v_in, rk, rv, scale=scale, v_affine=affine,
                                     include_input=include_input)
    got = torch.autograd.grad(out, ts, _t(ct), allow_unused=True)
    wk, wv = tattn.widen_kv(k_in, v_in, rk, rv, use_adain=use_adain, train_input=include_input)
    own = torch.autograd.grad(tattn.softmax_attention(q, wk, wv, scale), ts, _t(ct),
                              allow_unused=True)
    for name, g, r, o in zip(["q", "k_in", "v_in", "rk", "rv"], got, ref, own):
        if g is None:  # no path to the loss: JAX returns zeros, autograd nothing
            assert o is None and not np.asarray(r).any(), name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, err_msg=f"d{name}")
        np.testing.assert_allclose(g.numpy(), o.numpy(), atol=1e-4, err_msg=f"d{name} (own)")
    assert (got[1] is None) == (not include_input)
    assert (got[2] is None) == (not include_input and not use_adain)


def test_primal_unchanged(rng, monkeypatch):
    """With no gradient wanted the differentiable wrappers are the serving
    wrappers: same function called, same bits, under no_grad too."""
    q, k_in, v_in, rk, rv = (_t(x) for x in _shared_inputs(rng, 4))
    scale = 0.3
    calls = record_calls(monkeypatch, tsa, [n for n in dir(tsa) if n.endswith("_plain")])
    a = tfv.flash_attention(q, k_in, v_in, scale=scale)
    b_ = tsa.flash_attention(q, k_in, v_in, scale=scale)
    assert torch.equal(a, b_) and calls == ["flash_attention_plain"] * 2
    aff = tsa.adain_affine(v_in, rv)
    for inc in (True, False):
        a = tfv.shared_flash_attention(q, k_in, v_in, rk, rv, scale=scale, v_affine=aff,
                                       include_input=inc)
        b_ = tsa.shared_flash_attention(q, k_in, v_in, rk, rv, scale=scale, v_affine=aff,
                                        include_input=inc)
        assert torch.equal(a, b_)
    assert calls[2:] == ["shared_flash_bound_plain"] * 4
    # the algorithm switches reach the serving wrappers
    a = tfv.flash_attention(q, k_in, v_in, scale=scale, algo="online")
    assert torch.equal(a, tsa.flash_online(q, k_in, v_in, scale=scale))
    with torch.no_grad():
        qg = q.clone().requires_grad_()
        assert torch.equal(tfv.flash_attention(qg, k_in, v_in, scale=scale),
                           tsa.flash_attention(q, k_in, v_in, scale=scale))
    # and a wanted gradient leaves them: the LSE forward, not the bound kernel
    fwd = record_calls(monkeypatch, tfv, ["flash_fwd_lse_plain"])
    out = tfv.flash_attention(q.clone().requires_grad_(), k_in, v_in, scale=scale)
    assert fwd == ["flash_fwd_lse_plain"] and out.requires_grad
    np.testing.assert_allclose(out.detach().numpy(),
                               tsa.flash_attention(q, k_in, v_in, scale=scale).numpy(), atol=2e-5)


def test_backward_launches_only_what_is_asked(rng, monkeypatch):
    """dK/dV is not computed when only q wants a gradient, dQ not when only
    the references do."""
    q, k_in, v_in, rk, rv = (_t(x) for x in _shared_inputs(rng, 2))
    calls = record_calls(monkeypatch, tfv, ["flash_bwd_dq_plain", "flash_bwd_dkv_plain"])
    qg = q.clone().requires_grad_()
    tfv.shared_flash_attention(qg, k_in, v_in, rk, rv, scale=0.25,
                               include_input=False).sum().backward()
    assert calls == ["flash_bwd_dq_plain"] and qg.grad is not None
    del calls[:]
    rkg = rk.clone().requires_grad_()
    tfv.shared_flash_attention(q, k_in, v_in, rkg, rv, scale=0.25,
                               include_input=False).sum().backward()
    assert calls == ["flash_bwd_dkv_plain"] and rkg.grad.shape == rk.shape


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """A non-CPU, non-CUDA tensor raises instead of running a plain version."""
    q = torch.zeros((1, 1, 64, 64), device="meta")
    lse = torch.zeros((1, 1, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tfv.flash_fwd_lse(q, q, q, scale=1.0)
    with pytest.raises(ValueError, match="no kernel for device"):
        tfv.flash_bwd_dq(q, q, q, q, lse, lse, scale=1.0)
    with pytest.raises(ValueError, match="no kernel for device"):
        tfv.flash_bwd_dkv(q, q, q, q, lse, lse, scale=1.0)


def _attn_params(rng, c):
    def w():
        return jnp.asarray(rng.normal(size=(c, c)) * 0.2, jnp.float32)
    return {"to_q": {"kernel": w()}, "to_k": {"kernel": w()}, "to_v": {"kernel": w()},
            "to_out": {"kernel": w(), "bias": jnp.zeros((c,), jnp.float32)}}


@pytest.mark.parametrize("train_input", [False, True])
def test_attention_module_fused_grad(rng, train_input):
    """``attention(use_fused=True)`` under autograd: gradients w.r.t. the
    projection weights against the JAX module's, through the converter."""
    b, s, c, heads = 1, 32, 16, 2
    p = _attn_params(rng, c)
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    rk = rng.normal(size=(b, 2, heads, s, c // heads)).astype(np.float32)
    rv = rng.normal(size=(b, 2, heads, s, c // heads)).astype(np.float32)

    def jloss(p_):
        out, _ = jattn.attention(p_, jnp.asarray(x), heads=heads,
                                 ref_kv=(jnp.asarray(rk), jnp.asarray(rv)), use_adain=True,
                                 train_input=train_input, use_fused=True)
        return jnp.sum(out ** 2)

    ref = jax.grad(jloss)(p)
    tp = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, p))
    leaves = [t.requires_grad_() for mod in tp.values() for t in mod.values()]
    out, _ = tattn.attention(tp, _t(x), heads=heads, ref_kv=(_t(rk), _t(rv)), use_adain=True,
                             train_input=train_input, use_fused=True)
    grads = torch.autograd.grad((out ** 2).sum(), leaves, allow_unused=True)
    # refs-only: the input keys do not reach the loss (JAX returns zeros)
    assert any(g is None for g in grads) == (not train_input)
    it = iter(torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves))
    gtree = convert.to_jax_tree({name: {k: next(it) for k in mod} for name, mod in tp.items()})
    for name in p:
        for k in p[name]:
            np.testing.assert_allclose(gtree[name][k], np.asarray(ref[name][k]), atol=1e-4,
                                       err_msg=f"{name}.{k}")


def test_segment_softmax_sums_match_jax(rng):
    """Values, and gradients of a weighted sum w.r.t. q and the segments."""
    b, h, sq, s, d, n = 2, 2, 16, 32, 8, 3
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    segs = rng.normal(size=(n, b, h, s, d)).astype(np.float32)
    w = rng.normal(size=(b, h, sq, n)).astype(np.float32)
    scale = d ** -0.5

    def jloss(q_, segs_):
        sums = jattn.segment_softmax_sums(q_, segs_, scale)
        return jnp.sum(sums * jnp.asarray(w)), sums

    (_, ref), (gq, gs) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(q), jnp.asarray(segs))
    tq, tsegs = _t(q).requires_grad_(), _t(segs).requires_grad_()
    sums = tattn.segment_softmax_sums(tq, list(tsegs), scale)
    assert sums.shape == (b, h, sq, n)
    np.testing.assert_allclose(sums.detach().numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(sums.sum(-1).detach().numpy(), 1.0, atol=1e-6)
    tgq, tgs = torch.autograd.grad((sums * _t(w)).sum(), (tq, tsegs))
    np.testing.assert_allclose(tgq.numpy(), np.asarray(gq), atol=1e-6)
    np.testing.assert_allclose(tgs.numpy(), np.asarray(gs), atol=1e-6)
    # against the full probabilities of the unfused branch
    keys = tsegs.permute(1, 2, 0, 3, 4).reshape(b, h, n * s, d)
    _, probs = tattn.softmax_attention(tq, keys, keys, scale, return_probs=True)
    np.testing.assert_allclose(sums.detach().numpy(),
                               probs.reshape(b, h, sq, n, s).sum(-1).detach().numpy(), atol=1e-6)


def test_attention_module_seg_sums(rng):
    """``save_seg_sums`` through the module: one [B, h, Sq, n_seg] tensor per
    call with per-call references, equal to the JAX module's."""
    b, s, c, heads = 2, 16, 16, 2
    p = _attn_params(rng, c)
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    rk = rng.normal(size=(b, 3, heads, s, c // heads)).astype(np.float32)
    rv = rng.normal(size=(b, 3, heads, s, c // heads)).astype(np.float32)
    tp = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, p))
    for train_input in (True, False):
        _, jaux = jattn.attention(p, jnp.asarray(x), heads=heads,
                                  ref_kv=(jnp.asarray(rk), jnp.asarray(rv)),
                                  train_input=train_input, save_seg_sums=True)
        _, taux = tattn.attention(tp, _t(x), heads=heads, ref_kv=(_t(rk), _t(rv)),
                                  train_input=train_input, save_seg_sums=True, use_fused=True)
        assert taux["seg_sums"].shape == (b, heads, s, 3 + train_input)
        np.testing.assert_allclose(taux["seg_sums"].numpy(), np.asarray(jaux["seg_sums"]), atol=1e-6)
    _, taux = tattn.attention(tp, _t(x), heads=heads, save_seg_sums=True)
    assert "seg_sums" not in taux  # no references, no segments
