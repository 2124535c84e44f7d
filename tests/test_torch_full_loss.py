"""The port's whole generator loss against the JAX package's, on the CPU in
fp32, with every term live at once: L2, LPIPS, the ArcFace ID term on
aligned crops, the attention-entropy regulariser, the cycle term (the
per-sample ``degrade_with_params`` of the prediction), landmark attention,
the positive and negative reference-usage regularisers, the facial
components' L2 and LPIPS (one mask), and the vision-aided GAN's G term on the whole
image and on the three facial crops (the tiny DINOv2 of ``tests/test_gan.py``).
The attention maps have the tiny statics' nine shared layers (2 heads at 2x2
and 4x4, 1 head at 8x8; the input and 4 references); the random choices JAX
makes (the regularisers' layer, DiffAugment for the image and each crop, the
cycle's noise) are drawn with JAX and injected into the port.

Tolerances: each term relative 1e-5 (absolute 1e-6 for terms near zero);
the gradient w.r.t. ``out["output_image"]`` relative RMS <= 1e-4 and max-abs
<= 1e-3 of its largest entry. The gradient sums the cycle term's, whose
rounding derivative reads fractional parts of large DCT coefficients
(``tests/test_torch_degrade.py``), and the ID term's 1 - cos of nearly
parallel embeddings (``tests/test_torch_id_loss.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.configs import config as jcfg
from instantrestore_tpu.ops import image_ops as jimg
from instantrestore_tpu.training.losses import composite as jcomp
from instantrestore_tpu.training.losses import gan as jgan
from instantrestore_tpu.training.losses import id_loss as jid
from instantrestore_tpu.training.losses import lpips as jlpips
from instantrestore_tpu.models import vit as jvit
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.configs import config as tcfg
from instantrestore_tpu_torch.ops import image_ops as timg
from instantrestore_tpu_torch.training.losses import composite as tcomp

from test_torch_degrade import jax_cycle_noise
from test_torch_gan import TINY_VIT, jax_diff_augment_draws, sn_heads, tcfg as vit_tcfg
from test_torch_serving import random_tree

B, RES = 2, 64
LAYERS = [(2, 2)] * 3 + [(2, 4)] * 3 + [(1, 8)] * 3  # (heads, side) of the 9 shared layers
N_SEG = 5  # train_input: the input and 4 references
LOSS_REL, LOSS_ATOL, GRAD_REL_RMS, GRAD_MAX = 1e-5, 1e-6, 1e-4, 1e-3
LAMBDAS = dict(lambda_l2=1.0, lambda_lpips=5.0, lambda_id_loss=1.0, lambda_gan=0.5,
               lambda_attn_reg=0.1, lambda_cycle=1.0, lambda_landmark=50.0,
               lambda_pos_reg=0.1, lambda_neg_reg=0.1, lambda_facial_comp=0.5)
LANDMARK_LAYER = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs():
    rng = np.random.default_rng(0)
    img = lambda: rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32)  # noqa: E731
    probs = []
    for h, side in LAYERS:
        q = side * side
        z = rng.normal(size=(B, h, q, N_SEG * q)) * 2
        e = np.exp(z - z.max(-1, keepdims=True))
        probs.append((e / e.sum(-1, keepdims=True)).astype(np.float32))
    h, side = LAYERS[LANDMARK_LAYER]
    q = side * side
    z = rng.uniform(size=(B, h, q, q)).astype(np.float32)
    lms = [jid.ARCFACE_REFERENCE_POINTS * (RES / 112) * s + o
           for s, o in ((0.9, 3.0), (1.05, -2.0))]
    mats_pred, valid = jid.alignment_transforms([lms[0], None])
    mats_gt, _ = jid.alignment_transforms(lms)
    batch = {
        "gt": img(), "image": img(),
        "id_mats_pred": mats_pred, "id_mats_target": mats_gt, "id_valid": valid,
        "gt_attn_probs": z, "gt_attn_mask": rng.uniform(size=(B, q)) > 0.4,
        "gt_attn_cond": np.array([1, 3], np.int32),
        "pos_reg_idx": np.array([1, 2], np.int32), "neg_reg_idx": np.array([3, -1], np.int32),
        "facial_comps": [(rng.uniform(size=(B, RES, RES)) > 0.7).astype(np.float32)],
        "facial_comp_boxes": np.array([[[10, 8], [12, 36], [40, 20]],
                                       [[60, 60], [0, 0], [30, 50]]], np.int32),
    }
    cycle = {
        "blur_sigma_x": np.array([0.8, 2.0], np.float32),
        "blur_sigma_y": np.array([1.5, 0.4], np.float32),
        "blur_rotation": np.array([0.3, -1.0], np.float32),
        "downsample_factor": np.array([2, 4], np.int32),
        "noise_sigma": np.array([5.0, 15.0], np.float32),
        "jpeg_quality": np.array([40, 85], np.int32),
    }
    return img(), probs, batch, cycle


@pytest.fixture(scope="module")
def nets():
    lp = random_tree(jlpips.init_lpips_params, jax.random.PRNGKey(0), seed=3)
    lp["lins"] = [{"kernel": jnp.abs(l["kernel"]) * 0.05} for l in lp["lins"]]
    arc = random_tree(jid.init_arcface_params, jax.random.PRNGKey(0))
    vit = random_tree(jvit.init_vit_params, jax.random.PRNGKey(0), TINY_VIT)
    heads = sn_heads(jgan.init_discriminator_heads, 64, 32)
    jax_nets = dict(lpips_params=lp, arcface_params=arc, disc_backbone=vit, disc_heads=heads)
    torch_nets = {k: convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, v))
                  for k, v in jax_nets.items()}
    return jax_nets, torch_nets


@pytest.fixture(scope="module")
def both(nets):
    """JAX's loss terms and gradient, and the port's, on the same inputs."""
    jax_nets, torch_nets = nets
    pred, probs, batch, cycle = _inputs()
    key, cycle_key = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    jopt = jcfg.OptimConfig(**LAMBDAS)

    # the weights and inputs are arguments of the jitted function, not
    # constants that XLA would fold through the networks while compiling
    def jloss(p, jnets, jb, jprobs, jcycle):
        def degrade_fn(x):
            return jimg.degrade_with_params((x + 1) * 0.5, jcycle, cycle_key,
                                            resolution=RES) * 2.0 - 1.0

        return jcomp.compute_generator_loss(
            {"output_image": p, "attn_probs": jprobs}, jb, jopt, rng=key, vit_cfg=TINY_VIT,
            degrade_fn=degrade_fn, landmark_layer=LANDMARK_LAYER, **jnets)

    (_, jlosses), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(pred), jax_nets, batch, probs, cycle)

    # JAX's draws, injected: the layer, DiffAugment for the image and each crop, the noise
    crop_shapes = [(B, h, w) for h, w in tcomp.facial_comp_sizes(RES)]
    gan_draws = [jax_diff_augment_draws(key, B, RES, RES)] + [
        jax_diff_augment_draws(jax.random.fold_in(key, i + 1), *s)
        for i, s in enumerate(crop_shapes)]
    noise = jax_cycle_noise(cycle_key, timg.cycle_noise_shapes(B, RES, RES))
    tparams = {k: _t(v) for k, v in cycle.items()}

    def degrade_fn(x):
        return timg.degrade_with_params((x + 1) * 0.5, tparams, noise=noise,
                                        resolution=RES) * 2.0 - 1.0

    tp = _t(pred).requires_grad_()
    tb = {k: [_t(m) for m in v] if isinstance(v, list) else _t(v) for k, v in batch.items()}
    total, losses = tcomp.compute_generator_loss(
        {"output_image": tp, "attn_probs": [_t(x) for x in probs]}, tb,
        tcfg.OptimConfig(**LAMBDAS), layer_idx=int(jax.random.randint(key, (), 0, len(LAYERS))),
        vit_cfg=vit_tcfg(TINY_VIT), gan_draws=gan_draws, degrade_fn=degrade_fn,
        landmark_layer=LANDMARK_LAYER, **torch_nets)
    (tgrad,) = torch.autograd.grad(total, tp)
    return jlosses, np.asarray(jgrad), losses, tgrad.numpy()


EVERY_TERM = ["loss_l2", "loss_lpips", "loss_id", "sim_id", "loss_attn_reg", "loss_cycle",
              "loss_landmark", "loss_attn_pos_reg", "loss_attn_neg_reg", "loss_facial_comp_l2",
              "loss_facial_comp_lpips", "loss_g", "fc_loss_g", "loss"]


@pytest.mark.parametrize("term", EVERY_TERM)
def test_every_term_matches_jax(both, term):
    jlosses, _, losses, _ = both
    assert set(losses) == set(jlosses) == set(EVERY_TERM)
    got = float(losses[term].detach())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(jlosses[term]), rtol=LOSS_REL, atol=LOSS_ATOL,
                               err_msg=term)


def test_gradient_wrt_output_image_matches_jax(both):
    _, jgrad, _, tgrad = both
    assert np.abs(jgrad).max() > 0
    err = np.sqrt(((tgrad - jgrad) ** 2).sum() / (jgrad ** 2).sum())
    assert err <= GRAD_REL_RMS, err
    np.testing.assert_allclose(tgrad, jgrad, rtol=0, atol=GRAD_MAX * np.abs(jgrad).max())


def test_random_choices_come_from_a_generator(nets):
    """Without injected draws the GAN term draws DiffAugment from the
    generator (the same seed, the same loss) and refuses to run without one."""
    _, torch_nets = nets
    pred, probs, batch, _ = _inputs()
    cfg = tcfg.OptimConfig(lambda_l2=1.0, lambda_lpips=0.0, lambda_id_loss=0.0, lambda_gan=0.5,
                           lambda_facial_comp=0.5)
    tb = {k: [_t(m) for m in v] if isinstance(v, list) else _t(v) for k, v in batch.items()}
    kw = dict(vit_cfg=vit_tcfg(TINY_VIT), disc_backbone=torch_nets["disc_backbone"],
              disc_heads=torch_nets["disc_heads"])
    runs = [tcomp.compute_generator_loss({"output_image": _t(pred)}, tb, cfg,
                                         generator=torch.Generator().manual_seed(s), **kw)[1]
            for s in (0, 0, 1)]
    assert {"loss_g", "fc_loss_g"} <= set(runs[0])
    assert float(runs[0]["loss_g"]) == float(runs[1]["loss_g"]) != float(runs[2]["loss_g"])
    with pytest.raises(ValueError, match="gan_draws"):
        tcomp.compute_generator_loss({"output_image": _t(pred)}, tb, cfg, **kw)
