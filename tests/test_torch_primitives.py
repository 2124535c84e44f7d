"""Port primitives, FreeU, LoRA merge and scheduler vs the JAX package.

Same numpy inputs through both; fp32 on the CPU. Tolerance: 1e-5 relative
(plus 1e-5 absolute for values near zero) — the two differ only in the
order of fp32 sums inside convolutions and reductions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from instantrestore_tpu.models import freeu as jfreeu
from instantrestore_tpu.models import lora as jlora
from instantrestore_tpu.models import scheduler as jsched
from instantrestore_tpu.ops import primitives as jprim
from instantrestore_tpu_torch.convert import from_jax_tree
from instantrestore_tpu_torch.models import freeu as tfreeu
from instantrestore_tpu_torch.models import lora as tlora
from instantrestore_tpu_torch.models import scheduler as tsched
from instantrestore_tpu_torch.ops import primitives as tprim

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _with_lora(p, rng, rank=3):
    """Attach LoRA factors with a nonzero B (peft's zero init would hide a
    layout error)."""
    p = dict(p)
    w = p["kernel"]
    if w.ndim == 4:
        kh, kw, cin, cout = w.shape
        p["lora_A"] = jnp.asarray(rng.normal(size=(kh, kw, cin, rank)), jnp.float32)
        p["lora_B"] = jnp.asarray(rng.normal(size=(1, 1, rank, cout)), jnp.float32)
    else:
        cin, cout = w.shape
        p["lora_A"] = jnp.asarray(rng.normal(size=(cin, rank)), jnp.float32)
        p["lora_B"] = jnp.asarray(rng.normal(size=(rank, cout)), jnp.float32)
    return p


@pytest.mark.parametrize("stride,padding,lora,ksize", [
    (1, 1, False, 3), (1, 1, True, 3), (2, 1, True, 3), (2, 0, False, 3), (1, 0, True, 1),
])
def test_conv2d_matches_jax(rng, stride, padding, lora, ksize):
    p = jprim.init_conv2d(jax.random.PRNGKey(0), 5, 7, ksize)
    p["bias"] = jnp.asarray(rng.normal(size=7), jnp.float32)
    if lora:
        p = _with_lora(p, rng)
    x = rng.normal(size=(2, 9, 10, 5)).astype(np.float32)
    ref = jprim.conv2d(p, jnp.asarray(x), stride=stride, padding=padding, lora_scaling=0.5)
    out = tprim.conv2d(from_jax_tree(p), _t(x), stride=stride, padding=padding, lora_scaling=0.5)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("lora", [False, True])
def test_dense_and_geglu_match_jax(rng, lora):
    p = jprim.init_dense(jax.random.PRNGKey(1), 12, 16)
    p["bias"] = jnp.asarray(rng.normal(size=16), jnp.float32)
    if lora:
        p = _with_lora(p, rng)
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    tp = from_jax_tree(p)
    np.testing.assert_allclose(
        tprim.dense(tp, _t(x), lora_scaling=0.5).numpy(),
        _np(jprim.dense(p, jnp.asarray(x), lora_scaling=0.5)), **TOL)
    np.testing.assert_allclose(
        tprim.geglu(tp, _t(x), lora_scaling=0.5).numpy(),
        _np(jprim.geglu(p, jnp.asarray(x), lora_scaling=0.5)), **TOL)


def test_norms_match_jax(rng):
    x = rng.normal(size=(2, 6, 5, 8)).astype(np.float32) * 3 + 1
    p = {"scale": jnp.asarray(rng.normal(size=8), jnp.float32),
         "bias": jnp.asarray(rng.normal(size=8), jnp.float32)}
    tp = from_jax_tree(p)
    np.testing.assert_allclose(
        tprim.group_norm(tp, _t(x), num_groups=4, eps=1e-6).numpy(),
        _np(jprim.group_norm(p, jnp.asarray(x), num_groups=4, eps=1e-6)), **TOL)
    np.testing.assert_allclose(
        tprim.layer_norm(tp, _t(x)).numpy(), _np(jprim.layer_norm(p, jnp.asarray(x))), **TOL)


def test_upsample2x_conv_matches_jax(rng):
    p = jprim.init_conv2d(jax.random.PRNGKey(2), 6, 4, 3)
    p["bias"] = jnp.asarray(rng.normal(size=4), jnp.float32)
    x = rng.normal(size=(2, 5, 4, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tprim.nearest_upsample_2x(_t(x)).numpy(), _np(jprim.nearest_upsample_2x(jnp.asarray(x))))
    np.testing.assert_allclose(
        tprim.upsample2x_conv(from_jax_tree(p), _t(x)).numpy(),
        _np(jprim.upsample2x_conv(p, jnp.asarray(x))), **TOL)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 249, 999], np.int32)
    for dim, shift in ((320, 0.0), (32, 1.0)):
        ref = jprim.timestep_embedding(jnp.asarray(t), dim, downscale_freq_shift=shift)
        out = tprim.timestep_embedding(torch.from_numpy(t), dim, downscale_freq_shift=shift)
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("idx,hw", [(0, (8, 8)), (1, (6, 10)), (2, (4, 4)), (1, (5, 7))])
def test_freeu_matches_jax(rng, idx, hw):
    hid = rng.normal(size=(2, *hw, 6)).astype(np.float32)
    skip = rng.normal(size=(2, *hw, 4)).astype(np.float32)
    jh, js = jfreeu.apply_freeu(idx, jnp.asarray(hid), jnp.asarray(skip), jfreeu.FreeUParams())
    th, ts = tfreeu.apply_freeu(idx, _t(hid), _t(skip), tfreeu.FreeUParams())
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)


def test_merge_and_strip_lora_match_jax(rng):
    tree = {"conv1": _with_lora(jprim.init_conv2d(jax.random.PRNGKey(3), 4, 6, 3), rng),
            "proj": _with_lora(jprim.init_dense(jax.random.PRNGKey(4), 5, 7), rng),
            "norm": jprim.init_norm(6)}
    merged = tlora.merge_lora(from_jax_tree(tree), 0.25)
    ref = from_jax_tree(jlora.merge_lora(tree, 0.25))
    for name in ("conv1", "proj"):
        assert set(merged[name]) == {"weight", "bias"}
        np.testing.assert_allclose(merged[name]["weight"].numpy(), ref[name]["weight"].numpy(), **TOL)
    stripped = tlora.strip_lora(from_jax_tree(tree))
    assert "lora_A" not in stripped["conv1"] and "lora_B" not in stripped["proj"]


def test_scheduler_matches_jax(rng):
    abar_j = jsched.make_alphas_cumprod()
    abar_t = tsched.make_alphas_cumprod()
    np.testing.assert_array_equal(abar_t.numpy(), _np(abar_j))
    x = rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
    n = rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
    t = np.array([1, 249, 999], np.int32)
    zt_j = jsched.add_noise(abar_j, jnp.asarray(x), jnp.asarray(n), jnp.asarray(t))
    zt_t = tsched.add_noise(abar_t, _t(x), _t(n), torch.from_numpy(t).long())
    np.testing.assert_allclose(zt_t.numpy(), _np(zt_j), **TOL)
    x0_j = jsched.pred_original_sample(abar_j, jnp.asarray(n), zt_j, jnp.asarray(t))
    x0_t = tsched.pred_original_sample(abar_t, _t(n), zt_t, torch.from_numpy(t).long())
    np.testing.assert_allclose(x0_t.numpy(), _np(x0_j), rtol=1e-5, atol=1e-4)


def test_freeu_single_pixel_follows_diffusers():
    """At a 1x1 skip diffusers' fourier_filter scales the one bin once, so
    the skip becomes scale * skip. The JAX package's 4-bin projection counts
    that bin four times there (its f=0 and f=-1 basis vectors coincide);
    the port keeps the diffusers result. Only sub-2x2 skips differ, which
    no 512 px restore has (its smallest FreeU skip is 8x8)."""
    skip = torch.randn(2, 1, 1, 5)
    _, out = tfreeu.apply_freeu(0, torch.zeros(2, 1, 1, 4), skip, tfreeu.FreeUParams(s1=0.9))
    torch.testing.assert_close(out, 0.9 * skip)


@pytest.mark.parametrize("fold", [False, True], ids=["norm", "conv_bias_norm_silu"])
def test_group_norm_bf16_matches_jax_memory_light_path(rng, fold):
    """bf16 takes the JAX package's memory-light branch (fp32 mean and
    mean-square, one x * a + b pass in bf16): same up to bf16 rounding. JAX
    rounds x * a and + b separately, the port once, so allow two bf16 ulps:
    1e-2 relative plus 1e-2 absolute. ``conv_bias_norm_silu``: the port's
    conv without its bias, the bias handed to the norm as ``in_bias`` and
    SiLU as ``act``, against JAX's conv (bias added after it in bf16), norm
    and SiLU."""
    x = (rng.normal(size=(2, 6, 5, 16)) * 3 + 1).astype(np.float32)
    p = {"scale": jnp.asarray(rng.normal(size=16), jnp.float32),
         "bias": jnp.asarray(rng.normal(size=16), jnp.float32)}
    if not fold:
        ref = jprim.group_norm(p, jnp.asarray(x, jnp.bfloat16), num_groups=4, eps=1e-6)
        out = tprim.group_norm(from_jax_tree(p), _t(x).bfloat16(), num_groups=4, eps=1e-6)
    else:
        pc = jprim.init_conv2d(jax.random.PRNGKey(5), 16, 16, 3)
        pc["bias"] = jnp.asarray(rng.normal(size=16) * 2, jnp.float32)
        pc_bf = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), pc)
        ref = jax.nn.silu(jprim.group_norm(
            p, jprim.conv2d(pc_bf, jnp.asarray(x, jnp.bfloat16)), num_groups=4, eps=1e-6))
        tpc = {k: v.bfloat16() for k, v in from_jax_tree(pc).items()}
        h, bias = tprim.conv2d_bias_apart(tpc, _t(x).bfloat16())
        assert len(bias) == 1
        out = tprim.group_norm(from_jax_tree(p), h, num_groups=4, eps=1e-6, in_bias=bias,
                               act="silu")
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows", [False, True], ids=["bias_C", "bias_BC"])
def test_group_norm_plain_takes_bias_terms_and_silu(dtype, rows):
    """The plain path of ``group_norm(..., in_bias=b, act="silu")`` is
    ``silu(group_norm(x + b))`` in x's dtype, for a [C] and a [B, C] term,
    and a tuple of terms is added in order."""
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(2, 5, 3, 16, generator=gen) * 3 + 1).to(dtype)
    p = {"weight": torch.randn(16, generator=gen), "bias": torch.randn(16, generator=gen)}
    b = torch.randn((2, 16) if rows else (16,), generator=gen).to(dtype)
    c = torch.randn(16, generator=gen).to(dtype)
    bb = b[:, None, None, :] if rows else b
    ref = F.silu(tprim.group_norm(p, x + bb, num_groups=4))
    out = tprim.group_norm(p, x, num_groups=4, in_bias=(b,), act="silu")
    assert out.dtype == dtype and torch.equal(out, ref)
    two = tprim.group_norm(p, x, num_groups=4, in_bias=(c, b))
    assert torch.equal(two, tprim.group_norm(p, x + c + bb, num_groups=4))


def _vae_resnet_old(p, x, cfg, lora_scaling):
    """The VAE resnet as it was called before conv1's bias moved into norm2."""
    h = tprim.silu(tprim.group_norm(p["norm1"], x, num_groups=cfg.norm_num_groups,
                                    eps=cfg.norm_eps))
    h = tprim.conv2d(p["conv1"], h, lora_scaling=lora_scaling)
    h = tprim.silu(tprim.group_norm(p["norm2"], h, num_groups=cfg.norm_num_groups,
                                    eps=cfg.norm_eps))
    h = tprim.conv2d(p["conv2"], h, lora_scaling=lora_scaling)
    if "conv_shortcut" in p:
        x = tprim.conv2d(p["conv_shortcut"], x, padding=0, lora_scaling=lora_scaling)
    return x + h


def _unet_resnet_old(p, x, temb, cfg, lora_scaling):
    """The UNet resnet as it was called before conv1's bias and the
    time-embedding projection moved into norm2."""
    h = tprim.silu(tprim.group_norm(p["norm1"], x, num_groups=cfg.norm_num_groups,
                                    eps=cfg.norm_eps))
    h = tprim.conv2d(p["conv1"], h, lora_scaling=lora_scaling)
    h = h + tprim.dense(p["time_emb_proj"], tprim.silu(temb),
                        lora_scaling=lora_scaling)[:, None, None, :]
    h = tprim.silu(tprim.group_norm(p["norm2"], h, num_groups=cfg.norm_num_groups,
                                    eps=cfg.norm_eps))
    h = tprim.conv2d(p["conv2"], h, lora_scaling=lora_scaling)
    if "conv_shortcut" in p:
        x = tprim.conv2d(p["conv_shortcut"], x, padding=0, lora_scaling=lora_scaling)
    return x + h


def _conv_bias_after(fn, *modules):
    """``fn`` with every plain conv's bias, through ``conv2d`` of the
    primitives and of ``modules``, added after the conv in the compute dtype,
    as the JAX package and cuDNN's path do (oneDNN, the CPU's conv, adds it
    inside the conv before rounding)."""
    orig = tprim.conv2d
    modules = (tprim,) + modules

    def conv_then_bias(p, x, **kw):
        if "bias" not in p or "weight_int8" in p:
            return orig(p, x, **kw)
        y = orig({k: v for k, v in p.items() if k != "bias"}, x, **kw)
        return y + p["bias"].to(y.dtype)

    def wrapped():
        for m in modules:
            m.conv2d = conv_then_bias
        try:
            return fn()
        finally:
            for m in modules:
                m.conv2d = orig
    return wrapped


@pytest.mark.parametrize("conv1", ["plain", "lora", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("model", ["vae", "unet"])
def test_resnet_with_the_fold_equals_the_old_call_order(model, dtype, conv1):
    """A VAE and a UNet resnet whose conv1 bias (and time-embedding term) is
    added inside norm2 equal, bit for bit on the CPU, the same resnet called
    as before: in fp32 against it as it is; in bf16 against it with the conv
    bias added after the conv in bf16 (the JAX package's and cuDNN's order;
    the CPU's fused bias differs by bf16 rounding, within 2e-2). A LoRA conv1
    keeps its bias (added before its delta), an int8 one in its epilogue."""
    from instantrestore_tpu_torch.models import unet as tunet
    from instantrestore_tpu_torch.models import vae as tvae

    gen = torch.Generator().manual_seed(1)
    cin, cout, groups = 16, 24, 4
    if model == "vae":
        cfg = tvae.VAEConfig(norm_num_groups=groups)
        p = tvae._init_resnet(gen, cin, cout, None)
    else:
        cfg = tunet.UNetConfig(norm_num_groups=groups)
        p = tunet._init_resnet(gen, cin, cout, 32, None)
    for name in ("conv1", "conv2", "conv_shortcut"):
        p[name]["bias"] = torch.randn(cout, generator=gen)
    for name in ("norm1", "norm2"):
        p[name] = {k: torch.randn(v.shape, generator=gen) for k, v in p[name].items()}
    if conv1 == "lora":
        p["conv1"] = tprim.add_lora(p["conv1"], gen, 4, b_std=0.1)
    elif conv1 == "int8":
        p["conv1"] = tprim.quantize_conv_int8(p["conv1"])
    p = {k: {kk: (vv.to(dtype) if vv.is_floating_point() else vv) for kk, vv in v.items()}
         for k, v in p.items()}
    x = torch.randn(2, 6, 5, cin, generator=gen).to(dtype)
    temb = torch.randn(2, 32, generator=gen).to(dtype)
    if model == "vae":
        new = lambda: tvae._resnet(p, x, cfg=cfg, lora_scaling=0.5)
        old = lambda: _vae_resnet_old(p, x, cfg, 0.5)
    else:
        new = lambda: tunet._resnet(p, x, temb, cfg=cfg, lora_scaling=0.5)
        old = lambda: _unet_resnet_old(p, x, temb, cfg, 0.5)
    out = new()
    if dtype == torch.float32:
        assert torch.equal(out, old())
    else:
        mod = tvae if model == "vae" else tunet
        assert torch.equal(_conv_bias_after(new, mod)(), _conv_bias_after(old)())
        ref = old().float()
        assert float((out.float() - ref).norm() / ref.norm()) < 2e-2


def test_group_norm_routes_by_device_dtype_and_grad(monkeypatch):
    """CPU tensors take the plain path (the kernel loader fails if reached);
    fp32 CUDA tensors and CUDA inputs that want a gradient take it too, and a
    CUDA bf16 NHWC-contiguous input launches the kernel once with its shape
    (fake CUDA tensors, no card here: the plain path and the launcher are
    stubbed and record which ran); other CUDA inputs raise before any
    launch."""
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    from instantrestore_tpu_torch.ops import _build

    def no_kernel(name):
        raise AssertionError(f"the plain path reached the kernel loader for {name}")

    monkeypatch.setattr(_build, "load", no_kernel)
    p_cpu = {"weight": torch.ones(64), "bias": torch.zeros(64)}
    x_cpu = torch.randn(2, 4, 4, 64).bfloat16().requires_grad_()
    for x in (x_cpu, x_cpu.detach()):
        assert torch.equal(tprim.group_norm(p_cpu, x, act="silu"),
                           tprim.group_norm_plain(p_cpu, x, act="silu"))

    ran = []
    monkeypatch.setattr(tprim, "group_norm_plain", lambda p, x, **kw: ran.append("plain") or x)
    # the launcher's arguments after (fn, source, x): pointers of x, weight
    # and bias, affine fp32, b1, its stride, b2, its stride, out, workspace,
    # B, HW, C, G, blocks, act, eps
    monkeypatch.setattr(_build, "launch", lambda fn, src, x, *a: ran.append(
        (src, a[3], a[5], a[6] is None, a[7]) + a[10:14] + (a[15],)))
    with FakeTensorMode(allow_non_fake_inputs=True), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # data_ptr() of a fake tensor
        dev = torch.device("cuda", 0)

        def t(*shape, dtype=torch.bfloat16):
            return torch.empty(shape, dtype=dtype, device=dev)

        p = {"weight": t(64, dtype=torch.float32), "bias": t(64, dtype=torch.float32)}
        xg = t(2, 4, 4, 64).requires_grad_()
        tprim.group_norm(p, t(2, 4, 4, 64, dtype=torch.float32))
        tprim.group_norm(p, xg, in_bias=(t(64),), act="silu")
        tprim.group_norm(p, t(2, 4, 4, 64), in_bias=(t(2, 64).requires_grad_(),))
        with torch.no_grad():
            tprim.group_norm(p, xg, act="silu")
        out = tprim.group_norm(p, t(2, 4, 4, 64), num_groups=32, in_bias=(t(64), t(2, 64)),
                               act="silu")
        assert out.shape == (2, 4, 4, 64) and out.dtype == torch.bfloat16
        n_ran = len(ran)
        for bad, err in ((t(2, 64, 4, 4).permute(0, 2, 3, 1), ValueError),  # NCHW in memory
                         (t(2, 4, 4, 64, dtype=torch.float16), TypeError),
                         (t(2, 4, 4, 36), ValueError)):  # C not a multiple of 8
            pb = {k: t(bad.shape[-1], dtype=torch.float32) for k in ("weight", "bias")}
            with pytest.raises(err):
                tprim.group_norm(pb, bad, num_groups=4)
        with pytest.raises(ValueError):
            tprim.group_norm(p, t(2, 4, 4, 64), in_bias=(t(3, 64),))  # a term of no row count
        assert len(ran) == n_ran
    assert ran == ["plain"] * 3 + [("group_norm", 1, 0, True, 0, 2, 16, 64, 32, 1),
                                   ("group_norm", 1, 0, False, 64, 2, 16, 64, 32, 1)]
