"""The port's vision-aided GAN discriminator and its backbones against the
JAX package's, on the CPU in fp32: the tiny ViT of ``tests/test_gan.py``
and tiny DINO and CLIP variants (with the cubic position-embedding resize),
Swin, the ResNet18 and parsing-UNet encoders and the VGG16 trunk, each from
a JAX-initialised tree; the spectral-norm power iteration; DiffAugment with
JAX's draws injected; the SimpleD and MLP heads; and ``discriminate`` for
every ``disc_type`` JAX takes, on the G side (loss and its gradient into the
images, ``update_sn=False``) and the D side (loss, the new ``u`` vectors and
the gradient into the heads, ``update_sn=True``).

Tolerances: networks and gradients relative RMS <= 1e-5 and max-abs <= 1e-4
(of the largest entry where that exceeds 1); losses relative 1e-5; the
spectral norm's u vectors max-abs 1e-5 (unit vectors); DiffAugment 1e-6
(elementwise on the same draws). One exception: the image gradient through
the VGG16 trunk and the parsing UNet (vgg, face_seg) is held to relative RMS
<= 0.1. Their stacked ReLUs and max pools (VGG's stride-1 pools overlap)
make the fp32 gradient a step function of the image: nudging the image by a
relative 1e-5, which moves the loss by less than 1e-6, moves each package's
own gradient by about as much as the two packages differ, with DiffAugment's
zero-filled regions and without any augmentation
(``test_pooled_image_gradient_is_unstable_in_fp32``; measured on the test's
inputs, augmented / not: vgg 1.8e-2 / 2.8e-2 apart, each package moved by
1.4e-2 to 2.4e-2; face_seg 1.7e-4 / 4.4e-3 apart, moved by 1.3e-3 to
7.6e-3). The forward features agree to 1e-5 (``test_conv_backbones_match``).
The ResNet18 of face_normals, with one max pool, moves by 1e-3 under the
same nudge, but on these inputs both packages land on the same side of
every tie: 6e-7 apart, within the networks' bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.models import swin as jswin
from instantrestore_tpu.models import vit as jvit
from instantrestore_tpu.training.losses import backbones as jbb
from instantrestore_tpu.training.losses import gan as jgan
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.models import swin as tswin
from instantrestore_tpu_torch.models import vit as tvit
from instantrestore_tpu_torch.training.losses import backbones as tbb
from instantrestore_tpu_torch.training.losses import gan as tgan

from test_torch_id_loss import assert_net_close
from test_torch_serving import random_tree

LOSS_REL, U_ATOL, AUG_ATOL = 1e-5, 1e-5, 1e-6
POOLED_GRAD_REL_RMS = 0.1
POOLED = ("vgg", "face_seg")
# the image nudge that shows the pooled gradient's instability, and how far
# the port's gap to JAX may exceed the larger of the two packages' own moves
NUDGE, POOLED_GAP_FACTOR = 1e-5, 2.0
G_RNG = jax.random.PRNGKey(4)  # DiffAugment's key on the G side

TINY_VIT = jvit.ViTConfig(patch_size=14, embed_dim=64, depth=4, num_heads=4, mlp_ratio=2.0,
                          pos_grid=16, layerscale=True)
TINY_VIT_INTERP = jvit.ViTConfig(patch_size=14, embed_dim=32, depth=3, num_heads=2,
                                 mlp_ratio=2.0, pos_grid=37, layerscale=True)
TINY_DINO = jvit.ViTConfig(patch_size=16, embed_dim=48, depth=4, num_heads=4, mlp_ratio=2.0,
                           pos_grid=14, layerscale=False)
TINY_CLIP = jvit.ViTConfig(patch_size=32, embed_dim=64, depth=3, num_heads=4, mlp_ratio=2.0,
                           pos_grid=7, layerscale=False, quick_gelu=True, ln_pre=True,
                           proj_dim=24)
NARROW_SWIN = jswin.SwinConfig(embed_dim=24, depths=(2, 2, 2, 2))  # SWIN_TINY's heads, window
# discriminate runs Swin under SWIN_TINY's config, which fixes the width; the
# depth of each stage is the tree's
SHALLOW_SWIN = jswin.SwinConfig(depths=(2, 1, 1, 1))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _pair(jtree):
    return jtree, convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, jtree))


def tcfg(cfg):
    """The port's config of a JAX ViTConfig."""
    import dataclasses

    return tvit.ViTConfig(**dataclasses.asdict(cfg))


def sn_heads(init, *args, seed=1):
    """A JAX head tree from ``init`` with seeded kernels and unit u vectors."""
    tree = random_tree(init, jax.random.PRNGKey(0), *args, seed=seed)

    def unit(path, x):
        if getattr(path[-1], "key", None) == "u":
            return x / jnp.linalg.norm(x)
        return x

    return jax.tree_util.tree_map_with_path(unit, tree)


def jax_diff_augment_draws(rng, b, h, w):
    """The draws ``gan.diff_augment`` makes from ``rng``: six splits, and
    cutout's x from fold_in(r[5], 1)."""
    r = jax.random.split(rng, 6)
    ch = h // 2
    one = (b, 1, 1, 1)
    draws = {
        "brightness": jax.random.uniform(r[0], one, minval=-0.5, maxval=0.5),
        "saturation": jax.random.uniform(r[1], one, minval=0.0, maxval=2.0),
        "contrast": jax.random.uniform(r[2], one, minval=0.5, maxval=1.5),
        "shift_y": jax.random.randint(r[3], (b,), -(h // 8), h // 8 + 1),
        "shift_x": jax.random.randint(r[4], (b,), -(w // 8), w // 8 + 1),
        "cut_y": jax.random.randint(r[5], (b,), 0, h + (1 - ch % 2) - ch // 2),
        "cut_x": jax.random.randint(jax.random.fold_in(r[5], 1), (b,), 0,
                                    w + (1 - ch % 2) - ch // 2),
    }
    return {k: torch.from_numpy(np.asarray(v).reshape(b)) for k, v in draws.items()}


def _images(seed, b=2, res=40):
    return np.random.default_rng(seed).uniform(-1, 1, (b, res, res, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# backbones alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [TINY_VIT, TINY_VIT_INTERP, TINY_DINO],
                         ids=["dinov2", "dinov2_pos37", "dino"])
def test_vit_intermediate_layers_match(cfg):
    jtree, ttree = _pair(random_tree(jvit.init_vit_params, jax.random.PRNGKey(0), cfg))
    x = np.random.default_rng(2).normal(size=(2, 224, 224, 3)).astype(np.float32)
    want = jax.jit(lambda p, a: jvit.vit_intermediate_layers(p, a, n=3, cfg=cfg))(jtree, x)
    got = tvit.vit_intermediate_layers(ttree, _t(x), n=3, cfg=tcfg(cfg))
    assert len(got) == len(want) == 3
    for (gp, gc), (wp, wc) in zip(got, want):
        assert_net_close(gp, wp)
        assert_net_close(gc, wc)


def test_clip_multi_level_matches():
    jtree, ttree = _pair(random_tree(jvit.init_vit_params, jax.random.PRNGKey(0), TINY_CLIP))
    x = np.random.default_rng(3).normal(size=(2, 224, 224, 3)).astype(np.float32)
    want = jax.jit(lambda p, a: jvit.clip_multi_level(p, a, cfg=TINY_CLIP))(jtree, x)
    got = tvit.clip_multi_level(ttree, _t(x), cfg=tcfg(TINY_CLIP))
    for g, w in zip(got, want):
        assert_net_close(g, w)


@pytest.mark.parametrize("res", [256])
def test_swin_features_match(res):
    """A narrow Swin at 256 px, whose 64-wide grid is padded to a window
    multiple (``discriminate`` runs 224 px, which the window tiles)."""
    jtree, ttree = _pair(random_tree(jswin.init_swin_params, jax.random.PRNGKey(0), NARROW_SWIN))
    x = np.random.default_rng(4).normal(size=(1, res, res, 3)).astype(np.float32)
    want = jax.jit(lambda p, a: jswin.swin_features(p, a, cfg=NARROW_SWIN))(jtree, x)
    got = tswin.swin_features(ttree, _t(x), cfg=tswin.SwinConfig(embed_dim=24, depths=(2, 2, 2, 2)))
    assert got.shape == (1, res // 32, res // 32, 192)
    assert_net_close(got, want)


@pytest.mark.parametrize("which", ["face_normals", "face_seg", "vgg"])
def test_conv_backbones_match(which):
    init, feats = {"face_normals": (jbb.init_resnet18, jbb.face_normals_features),
                   "face_seg": (jbb.init_parsing_unet, jbb.face_seg_features),
                   "vgg": (jgan.init_vgg_backbone, jgan.vgg_backbone_features)}[which]
    tfeats = {"face_normals": tbb.face_normals_features, "face_seg": tbb.face_seg_features,
              "vgg": tgan.vgg_backbone_features}[which]
    jtree, ttree = _pair(random_tree(init, jax.random.PRNGKey(0)))
    x = _images(5, b=1, res=48)
    assert_net_close(tfeats(ttree, _t(x)), jax.jit(feats)(jtree, x))


def test_torch_layout_converters_agree():
    """The reference-layout converters (DINOv2, CLIP, Swin, ResNet18,
    parsing UNet) read one state dict into the same weights in both
    packages."""
    rng = np.random.default_rng(6)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    d = 8
    vit_sd = {"patch_embed.proj.weight": arr(d, 3, 14, 14), "patch_embed.proj.bias": arr(d),
              "cls_token": arr(1, 1, d), "pos_embed": arr(1, 5, d), "norm.weight": arr(d),
              "norm.bias": arr(d), "blocks.0.ls1.gamma": arr(d), "blocks.0.ls2.gamma": arr(d)}
    clip_sd = {"conv1.weight": arr(d, 3, 32, 32), "class_embedding": arr(d),
               "positional_embedding": arr(5, d), "ln_pre.weight": arr(d), "ln_pre.bias": arr(d),
               "ln_post.weight": arr(d), "ln_post.bias": arr(d), "proj": arr(d, 4)}
    for name, (sd, pre, names) in {
            "vit": (vit_sd, "blocks.0", ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1",
                                         "mlp.fc2")),
            "clip": (clip_sd, "transformer.resblocks.0", ("ln_1", "attn.out_proj", "ln_2",
                                                          "mlp.c_fc", "mlp.c_proj"))}.items():
        for n in names:
            sd[f"{pre}.{n}.weight"], sd[f"{pre}.{n}.bias"] = arr(d, d), arr(d)
    clip_sd["transformer.resblocks.0.attn.in_proj_weight"] = arr(3 * d, d)
    clip_sd["transformer.resblocks.0.attn.in_proj_bias"] = arr(3 * d)
    swin_sd = {"patch_embed.proj.weight": arr(d, 3, 4, 4), "patch_embed.proj.bias": arr(d),
               "patch_embed.norm.weight": arr(d), "patch_embed.norm.bias": arr(d),
               "norm3.weight": arr(2 * d), "norm3.bias": arr(2 * d),
               "layers.0.blocks.0.attn.relative_position_bias_table": arr(169, 2),
               "layers.0.downsample.norm.weight": arr(4 * d),
               "layers.0.downsample.norm.bias": arr(4 * d),
               "layers.0.downsample.reduction.weight": arr(2 * d, 4 * d),
               "layers.1.blocks.0.norm1.weight": arr(2 * d)}
    for s, w in ((0, d), (1, 2 * d)):
        for n in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"):
            swin_sd[f"layers.{s}.blocks.0.{n}.weight"] = arr(w, w)
            swin_sd[f"layers.{s}.blocks.0.{n}.bias"] = arr(w)
    swin_sd["layers.1.blocks.0.attn.relative_position_bias_table"] = arr(169, 4)

    def bn(sd, name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{name}.{k}"] = arr(c)

    res_sd = {"base.conv1.weight": arr(4, 3, 7, 7)}
    bn(res_sd, "base.bn1", 4)
    for li in range(1, 5):
        for b in range(2):
            base = f"base.layer{li}.{b}"
            res_sd[f"{base}.conv1.weight"] = arr(4, 4, 3, 3)
            res_sd[f"{base}.conv2.weight"] = arr(4, 4, 3, 3)
            bn(res_sd, f"{base}.bn1", 4)
            bn(res_sd, f"{base}.bn2", 4)
        res_sd[f"base.layer{li}.0.downsample.0.weight"] = arr(4, 4, 1, 1)
        bn(res_sd, f"base.layer{li}.0.downsample.1", 4)
    par_sd = {}
    for mod in [f"conv{i}" for i in range(1, 5)] + ["center"]:
        for j in (1, 2):
            par_sd[f"{mod}.conv{j}.0.weight"], par_sd[f"{mod}.conv{j}.0.bias"] = arr(4, 4, 3, 3), arr(4)
            bn(par_sd, f"{mod}.conv{j}.1", 4)
    for got, want in ((tvit.convert_vit_params(vit_sd), jvit.convert_vit_params(vit_sd)),
                      (tvit.convert_clip_visual(clip_sd), jvit.convert_clip_visual(clip_sd)),
                      (tswin.convert_swin_params(swin_sd), jswin.convert_swin_params(swin_sd)),
                      (tbb.convert_resnet18(res_sd, "base."), jbb.convert_resnet18(res_sd, "base.")),
                      (tbb.convert_parsing_unet(par_sd), jbb.convert_parsing_unet(par_sd))):
        want = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, want))
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the discriminator's parts
# ---------------------------------------------------------------------------


def test_sn_power_iteration_matches():
    rng = np.random.default_rng(7)
    for shape in ((16, 8), (3, 3, 12, 5)):
        k = rng.normal(size=shape).astype(np.float32) * 3.0
        u = rng.normal(size=shape[-1]).astype(np.float32)
        u /= np.linalg.norm(u)
        tp = convert.from_jax_tree({"kernel": k})
        tw = tp["weight"]
        for update in (True, False):
            wk, wu = jgan._sn_apply(jnp.asarray(k), jnp.asarray(u), update)
            gk, gu = tgan._sn_apply(tw, _t(u), update)
            assert_net_close(gk, convert.from_jax_tree({"kernel": np.asarray(wk)})["weight"])
            np.testing.assert_allclose(gu.numpy(), np.asarray(wu), rtol=0, atol=U_ATOL)
    # many iterations converge to a unit spectral norm
    w = _t(rng.normal(size=(16, 8)) * 5.0)
    u = tgan._sn_init(torch.Generator().manual_seed(0), 16)
    for _ in range(30):
        wn, u = tgan._sn_apply(w, u, True)
    np.testing.assert_allclose(np.linalg.svd(wn.numpy(), compute_uv=False)[0], 1.0, atol=1e-3)


def test_diff_augment_matches_jax_draws():
    x = _images(8, b=3, res=32)
    rng = jax.random.PRNGKey(3)
    want = jgan.diff_augment(jnp.asarray(x), rng)
    got = tgan.diff_augment(_t(x), jax_diff_augment_draws(rng, 3, 32, 32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=AUG_ATOL)
    assert (got.numpy() == 0).mean() > 0.1  # the cutout zeroed a square
    draws = tgan.diff_augment_draws(3, 32, 32, torch.Generator().manual_seed(0))
    assert set(draws) == set(jax_diff_augment_draws(rng, 3, 32, 32))
    assert torch.equal(tgan.diff_augment(_t(x), draws), tgan.diff_augment(
        _t(x), tgan.diff_augment_draws(3, 32, 32, torch.Generator().manual_seed(0))))


@pytest.mark.parametrize("for_real,for_g", [(True, False), (False, False), (False, True)])
def test_multilevel_sigmoid_loss_matches(for_real, for_g):
    rng = np.random.default_rng(9)
    logits = [rng.normal(size=(2, 4, 4)) * 3, rng.normal(size=(2, 4, 4)), rng.normal(size=(2, 1))]
    want = jgan.multilevel_sigmoid_loss([jnp.asarray(l, jnp.float32) for l in logits],
                                        for_real=for_real, for_g=for_g)
    got = tgan.multilevel_sigmoid_loss([_t(l) for l in logits], for_real=for_real, for_g=for_g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_REL)


def test_mlp_head_matches():
    jh, th = _pair(sn_heads(jgan.init_mlp_head, 24, 16))
    e = np.random.default_rng(10).normal(size=(2, 24)).astype(np.float32)
    (wl,), wh = jgan._mlp_head_apply(jh, jnp.asarray(e), update_sn=True)
    (gl,), gh = tgan._mlp_head_apply(th, _t(e), update_sn=True)
    assert_net_close(gl, wl)
    for k in ("fc1", "out"):
        np.testing.assert_allclose(gh[k]["u"].numpy(), np.asarray(wh[k]["u"]), atol=U_ATOL)


# ---------------------------------------------------------------------------
# discriminate, per disc_type
# ---------------------------------------------------------------------------

# disc_type -> (backbone init + its args, head init + its args, vit_cfg)
DISC = {
    "dinov2": ((jvit.init_vit_params, TINY_VIT),
               (jgan.init_discriminator_heads, 64, 32), TINY_VIT),
    "dino": ((jvit.init_vit_params, TINY_DINO), (jgan.init_discriminator_heads, 48, 16), TINY_DINO),
    "clip": ((jvit.init_vit_params, TINY_CLIP), (jgan.init_discriminator_heads, 64, 16, 24),
             TINY_CLIP),
    "vgg": ((jgan.init_vgg_backbone,), (jgan.init_simple_head, 512, 16, 3), None),
    "swin": ((jswin.init_swin_params, SHALLOW_SWIN), (jgan.init_simple_head, 768, 16, 3), None),
    "seg_ade": ((jswin.init_swin_params, SHALLOW_SWIN), (jgan.init_simple_head, 768, 16, 4), None),
    "det_coco": ((jswin.init_swin_params, SHALLOW_SWIN), (jgan.init_simple_head, 768, 16, 4),
                 None),
    "face_seg": ((jbb.init_parsing_unet,), (jgan.init_simple_head, 256, 16, 4), None),
    "face_normals": ((jbb.init_resnet18,), (jgan.init_simple_head, 512, 16, 4), None),
}


# the D side (the gradient into the heads) once per head family: the
# multi-level heads at both of their ``down`` settings and SimpleD
D_SIDE = ("dinov2", "clip", "face_seg")


@functools.lru_cache(maxsize=None)
def disc_trees(disc_type):
    """The JAX backbone and head trees of a disc_type and the port's copies,
    built once per module."""
    (binit, *bargs), (hinit, *hargs), _ = DISC[disc_type]
    return (*_pair(random_tree(binit, jax.random.PRNGKey(0), *bargs)),
            *_pair(sn_heads(hinit, *hargs)))


@functools.lru_cache(maxsize=None)
def jax_g_side(disc_type, diffaug=True):
    """JAX's G side of ``discriminate`` (for_g, update_sn) as one jitted
    function (images, backbone, heads) -> (image gradient, (loss, new
    heads)), compiled once per disc_type and DiffAugment setting. The
    weights are arguments, not constants that XLA would fold."""
    vcfg = DISC[disc_type][2]
    vit_kw = {} if vcfg is None else {"vit_cfg": vcfg}

    def g_fn(img, bb, heads):
        loss, new = jgan.discriminate(bb, heads, img, G_RNG, for_g=True, update_sn=True,
                                      diffaug=diffaug, disc_type=disc_type, **vit_kw)
        return loss.mean(), (loss, new)

    return jax.jit(jax.grad(g_fn, has_aux=True))


def _rel_rms(got, want):
    return float(np.sqrt(((got - want) ** 2).sum() / (want ** 2).sum()))


@pytest.mark.parametrize("disc_type", list(DISC))
def test_discriminate_matches(disc_type):
    """The G side (for_g, update_sn): loss, the new u vectors and the
    gradient into the images; for D_SIDE also the D side on real images
    (for_real, update_sn): loss and the gradient into the heads."""
    vcfg = DISC[disc_type][2]
    jbb_tree, tbb_tree, jheads, theads = disc_trees(disc_type)
    vit_kw = {} if vcfg is None else {"vit_cfg": vcfg}
    tvit_kw = {} if vcfg is None else {"vit_cfg": tcfg(vcfg)}
    x = _images(11, b=2 if vcfg is not None else 1)
    d_side = disc_type in D_SIDE

    def d_fn(heads, bb, img):
        loss, _ = jgan.discriminate(bb, heads, img, G_RNG, for_real=True, update_sn=True,
                                    disc_type=disc_type, **vit_kw)
        return loss.mean(), loss

    g_grad, (g_loss, g_new) = jax_g_side(disc_type)(jnp.asarray(x), jbb_tree, jheads)
    draws = jax_diff_augment_draws(G_RNG, *x.shape[:3])

    img = _t(x).requires_grad_()
    loss, new = tgan.discriminate(tbb_tree, theads, img, draws=draws, for_g=True,
                                  update_sn=True, disc_type=disc_type, **tvit_kw)
    loss.mean().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(g_loss), rtol=LOSS_REL)
    if disc_type in POOLED:
        assert _rel_rms(img.grad.numpy(), np.asarray(g_grad)) <= POOLED_GRAD_REL_RMS
    else:
        assert_net_close(img.grad, g_grad)
    want_new = dict(_leaves(convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, g_new))))
    before = dict(_leaves(theads))
    for name, got_u in _leaves(new):
        if name.endswith(".u"):
            np.testing.assert_allclose(got_u.numpy(), want_new[name].numpy(), rtol=0, atol=U_ATOL)
            if got_u.numel() > 1:  # a one-output layer's u is +-1 whatever the iteration
                assert not torch.equal(got_u, before[name]), name
    if not d_side:
        return

    d_grad, d_loss = jax.jit(jax.grad(d_fn, has_aux=True))(jheads, jbb_tree, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in _leaves(theads) if not k.endswith(".u")}
    loss, _ = tgan.discriminate(tbb_tree, _rebuild(theads, leaves), _t(x), draws=draws,
                                for_real=True, update_sn=True, disc_type=disc_type, **tvit_kw)
    grads = torch.autograd.grad(loss.mean(), list(leaves.values()))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(d_loss), rtol=LOSS_REL)
    want_grad = dict(_leaves(convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, d_grad))))
    for name, g in zip(leaves, grads):
        assert_net_close(g, want_grad[name])


@pytest.mark.parametrize("diffaug", [True, False], ids=["diffaug", "no_augment"])
@pytest.mark.parametrize("disc_type", POOLED)
def test_pooled_image_gradient_is_unstable_in_fp32(disc_type, diffaug):
    """Why POOLED's image gradient has its own bound: a nudge of the images
    by a relative NUDGE leaves the loss within 1e-6 in both packages and
    moves each one's own gradient by at least 1 / POOLED_GAP_FACTOR of the
    port's gap to JAX, with DiffAugment's zero-filled shift and cutout and
    without any augmentation (no flat region)."""
    jbb_tree, tbb_tree, jheads, theads = disc_trees(disc_type)
    x = _images(11, b=1)
    nudged = (x * (1 + NUDGE * np.random.default_rng(12).standard_normal(x.shape))
              ).astype(np.float32)
    draws = jax_diff_augment_draws(G_RNG, *x.shape[:3])

    def port(a):
        img = _t(a).requires_grad_()
        loss, _ = tgan.discriminate(tbb_tree, theads, img, draws=draws, diffaug=diffaug,
                                    for_g=True, update_sn=True, disc_type=disc_type)
        loss.mean().backward()
        return float(loss.detach().mean()), img.grad.numpy()

    def jax_side(a):
        grad, (loss, _) = jax_g_side(disc_type, diffaug)(jnp.asarray(a), jbb_tree, jheads)
        return float(loss.mean()), np.asarray(grad)

    (lt, gt), (lt_n, gt_n) = port(x), port(nudged)
    (lj, gj), (lj_n, gj_n) = jax_side(x), jax_side(nudged)
    np.testing.assert_allclose(lt, lj, rtol=LOSS_REL)
    assert abs(lt_n - lt) <= 1e-6 * abs(lt) and abs(lj_n - lj) <= 1e-6 * abs(lj)
    gap, moves = _rel_rms(gt, gj), (_rel_rms(gt_n, gt), _rel_rms(gj_n, gj))
    assert gap <= POOLED_GRAD_REL_RMS, gap
    assert gap <= POOLED_GAP_FACTOR * max(moves), (gap, moves)


def _rebuild(tree, leaves, prefix=""):
    """``tree`` with the leaves named in ``leaves`` replaced."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, leaves, f"{prefix}.{i}") for i, v in enumerate(tree)]
    return leaves.get(prefix, tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree
