"""The port's training losses and optimizer vs the JAX package's: LPIPS,
SSIM / MS-SSIM, every ported term of ``compute_generator_loss`` (value and
gradient w.r.t. the prediction), the learning-rate schedules and one AdamW +
clip update, all in fp32 on seeded numpy inputs.

Tolerances: 1e-5 on losses and their gradients (fp32 convolutions and
reductions in another order; the LPIPS trunk is 13 convolutions deep, so its
gradient gets 1e-4 relative to its largest entry), 1e-9 on learning rates,
1e-6 on updated parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instantrestore_tpu.configs import config as jcfg
from instantrestore_tpu.training import optim as joptim
from instantrestore_tpu.training.losses import composite as jcomp
from instantrestore_tpu.training.losses import lpips as jlpips
from instantrestore_tpu.training.losses import ssim as jssim
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.configs import config as tcfg
from instantrestore_tpu_torch.training import optim as toptim
from instantrestore_tpu_torch.training.losses import composite as tcomp
from instantrestore_tpu_torch.training.losses import lpips as tlpips
from instantrestore_tpu_torch.training.losses import ssim as tssim

from test_torch_serving import random_tree


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _images(rng, *shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def lpips_pair():
    """One LPIPS tree in both layouts: random trunk, non-negative heads."""
    tree = random_tree(jlpips.init_lpips_params, jax.random.PRNGKey(0), seed=3)
    tree["lins"] = [{"kernel": jnp.abs(l["kernel"]) * 0.05} for l in tree["lins"]]
    return tree, convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, tree))


def test_config_copy_matches_the_jax_package():
    """The port's own config module: same fields and defaults, section by
    section, and the same decoding of YAML-style overrides."""
    for name in ("ComputeConfig", "OptimConfig", "DataConfig", "ModelConfig", "LogConfig",
                 "TrainStepsConfig"):
        assert (jcfg.encode_config(getattr(jcfg, name)())
                == tcfg.encode_config(getattr(tcfg, name)())), name
    ov = ["optim.scheduler_type=linear", "--model.use_adain=true", "compute.batch_size=2",
          "data.data_root=a,b"]
    assert jcfg.encode_config(jcfg.load_config(None, ov)) == tcfg.encode_config(
        tcfg.load_config(None, ov))
    with pytest.raises(ValueError, match="unknown config field"):
        tcfg.load_config(None, ["optim.no_such_field=1"])


def test_lpips_tree_converts(lpips_pair):
    jtree, ttree = lpips_pair
    assert ttree["vgg"][0][0]["weight"].shape == (64, 3, 3, 3)
    assert [tuple(l["weight"].shape) for l in ttree["lins"]] == [
        (1, c, 1, 1) for c in tlpips.LIN_CHANNELS]
    back = convert.to_jax_tree(ttree)
    for a, b in zip(jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_lpips_matches_jax(rng, lpips_pair):
    jtree, ttree = lpips_pair
    a, b = _images(rng, 2, 32, 32, 3), _images(rng, 2, 32, 32, 3)
    ref, gref = jax.value_and_grad(
        lambda x: jlpips.lpips(jtree, x, jnp.asarray(b)).sum())(jnp.asarray(a))
    ta = _t(a).requires_grad_()
    out = tlpips.lpips(ttree, ta, _t(b))
    assert out.shape == (2,)
    np.testing.assert_allclose(float(out.sum().detach()), float(ref), rtol=1e-5)
    (g,) = torch.autograd.grad(out.sum(), ta)
    np.testing.assert_allclose(g.numpy(), np.asarray(gref), atol=1e-4 * np.abs(gref).max())
    np.testing.assert_allclose(tlpips.lpips(ttree, _t(a), _t(a)).numpy(), 0.0, atol=1e-7)


def test_lpips_init_and_state_dict_conversion():
    gen = torch.Generator().manual_seed(0)
    p = tlpips.init_lpips_params(gen)
    assert [len(s) for s in p["vgg"]] == [2, 2, 3, 3, 3]
    assert all((l["weight"] >= 0).all() for l in p["lins"])
    vgg_sd, lin_sd = {}, {}
    for conv_ids, stage in zip(tlpips._TV_CONV_IDX, p["vgg"]):
        for ci, conv in zip(conv_ids, stage):
            vgg_sd[f"features.{ci}.weight"], vgg_sd[f"features.{ci}.bias"] = conv["weight"], conv["bias"]
    for i, lin in enumerate(p["lins"]):
        lin_sd[f"lin{i}.model.1.weight" if i % 2 else f"lins.{i}.model.1.weight"] = lin["weight"]
    q = tlpips.convert_lpips_params(vgg_sd, lin_sd)
    x, y = (torch.rand((1, 32, 32, 3), generator=gen) * 2 - 1 for _ in range(2))
    assert torch.equal(tlpips.lpips(p, x, y), tlpips.lpips(q, x, y))


@pytest.mark.parametrize("reduce", [True, False])
def test_ssim_matches_jax(rng, reduce):
    a, b = rng.uniform(0, 1, (2, 40, 36, 3)).astype(np.float32), rng.uniform(0, 1, (2, 40, 36, 3)).astype(np.float32)
    ref = jssim.ssim(jnp.asarray(a), jnp.asarray(b), reduce=reduce)
    out = tssim.ssim(_t(a), _t(b), reduce=reduce)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_ms_ssim_matches_jax(rng):
    a = rng.uniform(0, 1, (2, 181, 177, 3)).astype(np.float32)  # odd sides: padded pools
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    ref, gref = jax.value_and_grad(lambda x: jssim.ms_ssim(x, jnp.asarray(b)))(jnp.asarray(a))
    ta = _t(a).requires_grad_()
    out = tssim.ms_ssim(ta, _t(b))
    np.testing.assert_allclose(float(out), float(ref), atol=1e-5)
    (g,) = torch.autograd.grad(out, ta)
    np.testing.assert_allclose(g.numpy(), np.asarray(gref), atol=1e-6)
    with pytest.raises(ValueError, match="too small"):
        tssim.ms_ssim(_t(a[:, :160, :160]), _t(b[:, :160, :160]))


# ---------------------------------------------------------------------------
# the composite loss, term by term
# ---------------------------------------------------------------------------

B, H, Q = 2, 2, 16


def _probs(rng, n_seg, layers=3):
    """Seeded attention maps [B, H, Q, n_seg * Q] with rows summing to 1."""
    out = []
    for _ in range(layers):
        z = rng.normal(size=(B, H, Q, n_seg * Q)) * 2
        e = np.exp(z - z.max(-1, keepdims=True))
        out.append((e / e.sum(-1, keepdims=True)).astype(np.float32))
    return out


def _loss_pair(rng, lpips_pair, jopt, topt, *, train_input, with_probs=False, with_sums=False,
               lpips_on=False, extra=None, size=32, landmark_layer=None):
    """value and d/d(prediction) of the JAX and the port's composite loss on
    one seeded output/batch."""
    pred, gt = _images(rng, B, size, size, 3), _images(rng, B, size, size, 3)
    n_seg = 5 if train_input else 4  # the loss counts 4 references (+ the input)
    probs = _probs(rng, n_seg) if (with_probs or with_sums) else None
    sums = [p.reshape(B, H, Q, n_seg, Q).sum(-1) for p in probs] if with_sums else None
    batch = dict(extra or {})
    batch["gt"] = gt
    jtree, ttree = lpips_pair

    # the layer JAX draws from its key is injected into the port
    key = jax.random.PRNGKey(7)

    def jloss(p):
        out = {"output_image": p}
        if with_probs:
            out["attn_probs"] = [jnp.asarray(x) for x in probs]
        if with_sums:
            out["attn_seg_sums"] = [jnp.asarray(x) for x in sums]
        jb = {k: [jnp.asarray(m) for m in v] if isinstance(v, list) else jnp.asarray(v)
              for k, v in batch.items()}
        total, losses = jcomp.compute_generator_loss(
            out, jb, jopt, rng=key, lpips_params=jtree if lpips_on else None,
            train_input=train_input, landmark_layer=landmark_layer)
        return total, losses

    (jtotal, jlosses), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(pred))
    tp = _t(pred).requires_grad_()
    out = {"output_image": tp}
    if with_probs:
        out["attn_probs"] = [_t(x) for x in probs]
    if with_sums:
        out["attn_seg_sums"] = [_t(x) for x in sums]
    tb = {k: [torch.from_numpy(np.asarray(m)) for m in v] if isinstance(v, list)
          else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    total, losses = tcomp.compute_generator_loss(
        out, tb, topt, layer_idx=int(jax.random.randint(key, (), 0, 3)),
        lpips_params=ttree if lpips_on else None, train_input=train_input,
        landmark_layer=landmark_layer)
    (tgrad,) = torch.autograd.grad(total, tp)
    return (jtotal, jlosses, np.asarray(jgrad)), (total, losses, tgrad.numpy())


def _same(jres, tres, terms):
    (jtotal, jlosses, jgrad), (total, losses, tgrad) = jres, tres
    assert set(losses) == set(jlosses) and set(terms) <= set(losses), (set(losses), set(jlosses))
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(tgrad, jgrad, atol=1e-4 * max(np.abs(jgrad).max(), 1e-6))


def _cfgs(**kw):
    base = dict(lambda_l2=1.0, lambda_lpips=1.0, lambda_id_loss=0.0, lambda_gan=0.0)
    base.update(kw)
    return jcfg.OptimConfig(**base), tcfg.OptimConfig(**base)


@pytest.mark.parametrize("case", ["l2", "l1", "lpips", "ssim", "facial_comp"])
def test_image_terms_match_jax(rng, lpips_pair, case):
    kw, extra, size, lp = {}, None, 32, False
    if case == "l1":
        kw = dict(lambda_l1=2.0)
    elif case == "lpips":
        lp = True
    elif case == "ssim":
        kw, size = dict(lambda_ssim=0.5), 176
    elif case == "facial_comp":
        lp, kw = True, dict(lambda_facial_comp=0.3, lambda_l2=2.0)
        extra = {"facial_comps": [(rng.uniform(size=(B, 32, 32)) > 0.6).astype(np.float32)
                                  for _ in range(3)]}
    jres, tres = _loss_pair(rng, lpips_pair, *_cfgs(**kw), train_input=True, lpips_on=lp,
                            extra=extra, size=size)
    terms = {"l2": ["loss_l2"], "l1": ["loss_l1"], "lpips": ["loss_l2", "loss_lpips"],
             "ssim": ["loss_ssim"],
             "facial_comp": ["loss_facial_comp_l2", "loss_facial_comp_lpips"]}[case]
    _same(jres, tres, terms)
    assert ("loss_l2" in tres[1]) == (case != "l1")  # l1 takes precedence over l2


@pytest.mark.parametrize("train_input", [True, False])
@pytest.mark.parametrize("source", ["sums", "probs"])
def test_attention_terms_match_jax(rng, lpips_pair, train_input, source):
    """Entropy regulariser and the per-sample positive / negative reference
    regularisers, from streamed segment sums and from probabilities; a -1
    index masks its sample."""
    extra = {"pos_reg_idx": np.array([1, -1], np.int32), "neg_reg_idx": np.array([2, 0], np.int32)}
    cfgs = _cfgs(lambda_attn_reg=0.01, lambda_pos_reg=0.1, lambda_neg_reg=0.2)
    jres, tres = _loss_pair(rng, lpips_pair, *cfgs, train_input=train_input,
                            with_probs=source == "probs", with_sums=source == "sums",
                            extra=extra)
    _same(jres, tres, ["loss_attn_reg", "loss_attn_pos_reg", "loss_attn_neg_reg"])


def test_attention_terms_from_sums_equal_those_from_probs(rng):
    for train_input in (True, False):
        n_seg = 5 if train_input else 4
        probs = [_t(p) for p in _probs(rng, n_seg)]
        sums = [p.reshape(B, H, Q, n_seg, Q).sum(-1) for p in probs]
        a = tcomp.attention_entropy_reg(probs, n_seg, train_input=train_input)
        b = tcomp.attention_entropy_reg_from_sums(sums, n_seg, train_input=train_input)
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
        np.testing.assert_allclose(tcomp.reference_usage_means_per_sample(probs, 2).numpy(),
                                   sums[2].sum(dim=(1, 2)).numpy(), rtol=1e-5)


def test_landmark_term_matches_jax(rng, lpips_pair):
    gt = _probs(rng, 1, layers=1)[0][:1]            # [1, H, Q, Q], shared by the batch
    extra = {"gt_attn_probs": gt, "gt_attn_mask": (rng.uniform(size=(1, Q)) > 0.5),
             "gt_attn_cond": np.array([1, 3], np.int32)}
    jres, tres = _loss_pair(rng, lpips_pair, *_cfgs(lambda_landmark=2.0), train_input=True,
                            with_probs=True, extra=extra, landmark_layer=2)
    _same(jres, tres, ["loss_landmark"])
    # and the term alone, with a gradient w.r.t. the probabilities
    probs = _probs(rng, 5, layers=1)[0]
    jref, jg = jax.value_and_grad(lambda p: jcomp.landmark_attention_loss(
        p, jnp.asarray(gt), jnp.asarray(extra["gt_attn_mask"]), jnp.asarray(extra["gt_attn_cond"])))(
        jnp.asarray(probs))
    tp = _t(probs).requires_grad_()
    out = tcomp.landmark_attention_loss(tp, _t(gt), torch.from_numpy(extra["gt_attn_mask"]),
                                        torch.from_numpy(extra["gt_attn_cond"]))
    np.testing.assert_allclose(float(out), float(jref), rtol=1e-5)
    np.testing.assert_allclose(torch.autograd.grad(out, tp)[0].numpy(), np.asarray(jg), atol=1e-6)


def test_crop_with_boxes_matches_jax(rng):
    img = _images(rng, 3, 20, 24, 3)
    origins = np.array([[0, 0], [5, 7], [18, 22]], np.int32)  # the last is clamped inside
    ref = jcomp.crop_with_boxes(jnp.asarray(img), jnp.asarray(origins), 6, 8)
    out = tcomp.crop_with_boxes(_t(img), torch.from_numpy(origins), 6, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _term_inputs(term):
    """The network or function each of the ID, cycle and GAN terms needs, at
    a tiny size (random weights)."""
    from instantrestore_tpu_torch.models.vit import ViTConfig, init_vit_params
    from instantrestore_tpu_torch.training.losses.gan import init_discriminator_heads
    from instantrestore_tpu_torch.training.losses.id_loss import init_arcface_params

    gen = torch.Generator().manual_seed(0)
    if term == "id_loss":
        return dict(arcface_params=init_arcface_params(gen))
    if term == "cycle":
        return dict(degrade_fn=lambda x: x * 0.5)
    cfg = ViTConfig(embed_dim=16, depth=2, num_heads=2, mlp_ratio=2.0, pos_grid=16)
    return dict(disc_backbone=init_vit_params(gen, cfg), vit_cfg=cfg, generator=gen,
                disc_heads=init_discriminator_heads(gen, embed_dim=16, out_ch=8))


@pytest.mark.parametrize("term,key", [
    ("id_loss", "loss_id"),
    ("cycle", "loss_cycle"),
    ("gan", "loss_g"),
], ids=["id_loss-kw0", "cycle-kw1", "gan-kw2"])  # the ids these cases have always had
def test_unported_terms_raise(rng, term, key):
    """The ID, cycle and adversarial terms were refused before they were
    ported; now, given their inputs, each is computed (finite, and in the
    total) rather than refused or skipped; without them the loss runs as
    before. Their values against JAX's: tests/test_torch_full_loss.py."""
    cfg = tcfg.OptimConfig(lambda_cycle=1.0)  # lambda_id_loss and lambda_gan default > 0
    out = {"output_image": _t(_images(rng, 1, 32, 32, 3))}
    batch = {"gt": _t(_images(rng, 1, 32, 32, 3)), "image": _t(_images(rng, 1, 32, 32, 3))}
    total, losses = tcomp.compute_generator_loss(out, batch, cfg, **_term_inputs(term))
    assert key in losses and torch.isfinite(losses[key]) and torch.isfinite(total)
    assert float(total) != float(losses["loss_l2"]) * cfg.lambda_l2
    total, losses = tcomp.compute_generator_loss(out, batch, cfg)
    assert set(losses) == {"loss_l2", "loss"} and torch.isfinite(total)


# ---------------------------------------------------------------------------
# schedules and the optimizer
# ---------------------------------------------------------------------------

SCHEDULERS = ["CONSTANT", "CONSTANT_WITH_WARMUP", "LINEAR", "COSINE", "COSINE_WITH_RESTARTS",
              "POLYNOMIAL"]


@pytest.mark.parametrize("warmup", [0, 7])
@pytest.mark.parametrize("name", SCHEDULERS)
def test_lr_schedule_matches_jax(name, warmup):
    kw = dict(lr_warmup_steps=warmup, lr_num_cycles=2, lr_power=2.0, learning_rate=3e-4)
    js = joptim.make_lr_schedule(
        jcfg.OptimConfig(scheduler_type=jcfg.SchedulerType[name], **kw), 40)
    ts = toptim.make_lr_schedule(
        tcfg.OptimConfig(scheduler_type=tcfg.SchedulerType[name], **kw), 40)
    for step in range(0, 46):
        np.testing.assert_allclose(ts(step), float(js(step)), atol=1e-9, err_msg=f"step {step}")
    if warmup and name != "CONSTANT":
        assert ts(0) == 0.0  # every warm-up starts at a rate of 0


def test_step_scheduler_is_refused():
    with pytest.raises(ValueError, match="unsupported scheduler"):
        toptim.make_lr_schedule(tcfg.OptimConfig(scheduler_type=tcfg.SchedulerType.STEP), 10)


@pytest.mark.parametrize("grad_scale", [0.01, 30.0], ids=["below_clip", "above_clip"])
def test_adamw_clip_update_matches_optax(rng, grad_scale):
    """Three masked AdamW + clip updates of a small tree against
    ``make_optimizer`` of the JAX package: the trainable leaves agree, the
    frozen ones are untouched and hold no state."""
    shapes = {"a": {"kernel": (4, 6), "lora_A": (4, 2), "lora_B": (2, 6)},
              "b": [{"kernel": (3, 3, 2, 5), "bias": (5,)}, {"scale": (7,), "bias": (7,)}]}
    jparams = jax.tree_util.tree_map(lambda s: jnp.asarray(rng.normal(size=s), jnp.float32), shapes,
                                     is_leaf=lambda x: isinstance(x, tuple))
    jmask = {"a": {"kernel": False, "lora_A": True, "lora_B": True},
             "b": [{"kernel": True, "bias": True}, {"scale": False, "bias": False}]}
    kw = dict(learning_rate=1e-2, lr_warmup_steps=0, clip_grad_max_norm=1.0)
    jopt = joptim.make_optimizer(
        jcfg.OptimConfig(scheduler_type=jcfg.SchedulerType.COSINE, **kw), 20, jmask)
    tparams = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, jparams))
    tmask = {"a": {"weight": False, "lora_A": True, "lora_B": True},
             "b": [{"weight": True, "bias": True}, {"weight": False, "bias": False}]}
    topt = toptim.make_optimizer(
        tcfg.OptimConfig(scheduler_type=tcfg.SchedulerType.COSINE, **kw), 20, tmask)
    start = jax.tree_util.tree_map(np.asarray, jparams)
    state = jopt.init(jparams)
    for _ in range(3):
        # frozen leaves come with zero gradients, as freeze_non_trainable leaves them
        # (optax.masked passes a masked-out leaf's "update" through as it is)
        jgrads = jax.tree_util.tree_map(
            lambda p, m: jnp.asarray(rng.normal(size=p.shape) * grad_scale * m, jnp.float32),
            jparams, jmask)
        updates, state = jopt.update(jgrads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, jgrads))
        given = [g.clone() for g in toptim.trainable_leaves(tgrads, tmask)]
        topt.update(tparams, toptim.trainable_leaves(tgrads, tmask))
        assert all(torch.equal(a, b) for a, b in zip(given, toptim.trainable_leaves(tgrads, tmask)))
        norm = np.sqrt(sum(float((g ** 2).sum()) for g in given))
        np.testing.assert_allclose(float(topt.last_grad_norm), norm, rtol=1e-5)
        assert (norm > 1.0) == (grad_scale > 1)
    back = convert.to_jax_tree(tparams)
    for (path, ref), got, m, s0 in zip(jax.tree_util.tree_leaves_with_path(jparams),
                                       jax.tree_util.tree_leaves(back),
                                       jax.tree_util.tree_leaves(jmask),
                                       jax.tree_util.tree_leaves(start)):
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-6, err_msg=str(path))
        assert (not np.array_equal(got, s0)) == m, path
    assert topt.count == 3 and len(topt.exp_avg) == 4
    with pytest.raises(ValueError, match="another param tree"):
        topt.update(convert.from_jax_tree(start), given)


def test_freeze_and_mask_follow_the_jax_package(rng):
    """``trainable_mask`` marks the leaves the JAX package marks (through the
    converter's naming), ``freeze_non_trainable`` sets requires_grad by it and
    ``count_lora_params`` counts the same elements."""
    from instantrestore_tpu.models import lora as jlora
    from instantrestore_tpu.models import unet as junet
    from instantrestore_tpu_torch.models import lora as tlora

    cfg = junet.UNetConfig(sample_size=16, block_out_channels=(32, 64, 64, 64),
                           attention_heads=(1, 2, 2, 2), cross_attention_dim=16, norm_num_groups=8)
    base = random_tree(lambda k: junet.init_unet_params(k, cfg), jax.random.PRNGKey(0))
    jtree = jlora.attach_lora(base, jax.random.PRNGKey(1), 4, jlora.UNET_LORA_TARGETS)
    jmask = jlora.trainable_mask(jtree, extra_trainable=("conv_in",))
    ttree = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, jtree))
    tmask = tlora.trainable_mask(ttree, extra_trainable=("conv_in",))
    # lay the port's mask beside JAX's through the converter's naming
    as_floats = jax.tree_util.tree_map(lambda m, t: torch.full_like(t, float(m)), tmask, ttree)
    back = convert.to_jax_tree(as_floats)
    jl, tl = jax.tree_util.tree_leaves_with_path(jmask), jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    assert all(bool(m) == bool(t.flat[0]) for (_, m), (_, t) in zip(jl, tl))
    assert tlora.count_lora_params(ttree) == jlora.count_lora_params(jtree) > 0
    toptim.freeze_non_trainable(ttree, tmask)
    leaves = toptim.trainable_leaves(ttree, tmask)
    assert all(t.requires_grad for t in leaves) and len(leaves) == sum(m for _, m in jl)
    assert ttree["conv_in"]["weight"].requires_grad and ttree["conv_in"]["bias"].requires_grad
    assert not ttree["conv_out"]["weight"].requires_grad and ttree["conv_out"]["lora_A"].requires_grad
    n_req = sum(t.requires_grad for t in jax.tree_util.tree_leaves(ttree))
    assert n_req == len(leaves)
