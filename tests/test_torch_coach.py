"""The port's trainer against the JAX package's, on the CPU in fp32.

Parity (one module-scoped JAX Coach and its port twin, tiny widths at 128 px,
the same converted weights, the same collated ``RestoreDataset`` batch; the
draws JAX makes from its keys are made again with its own helpers and
injected): one G step (every loss term the Coach runs: L2, LPIPS, the ID
term on the dataset's aligned crops, the attention-entropy and pos/neg
regularisers, the cycle term, the facial components' L2 and LPIPS and the
GAN term with its crops) and the trainable leaves after its AdamW update;
one D step on the same prediction (the loss, the heads after AdamW and the
new ``u`` vectors); gradient accumulation against ``optax.MultiSteps``.
128 px, not 64: at 64 px the UNet's deepest skip is 1 x 1, where the JAX
package's FreeU filter deviates from diffusers' (ROADMAP Queue 3 item 3). One
layer a block (six shared layers), to keep JAX's compile of its G step short.

Tolerances: loss terms relative 1e-5 (absolute 1e-6 near zero, as
``tests/test_torch_full_loss.py``); the prediction max-abs 1e-3 (as
``tests/test_torch_cold.py`` holds output images); the u vectors max-abs
1e-5; AdamW's first step (lr 1e-3) on every trainable entry within twice the
step, at most 0.5% of the entries (those whose gradient is rounding noise)
a step of the other sign, the rest within relative RMS 1e-3 of JAX's step
on the D heads and 1e-2 on the G leaves; optimizer moments and params under
accumulation 1e-6.

The port's Coach alone (smoke, validation, resume, the entry point) is in
``tests/test_torch_coach_port.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from instantrestore_tpu.configs import config as jcfg
from instantrestore_tpu.data import datasets as jds
from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu.models import vit as jvit
from instantrestore_tpu.training import coach as jcoach_mod
from instantrestore_tpu.training import optim as joptim
from instantrestore_tpu.training.losses import gan as jgan
from instantrestore_tpu.training.losses import id_loss as jid
from instantrestore_tpu.training.losses import lpips as jlpips
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.configs import config as tcfg
from instantrestore_tpu_torch.data import datasets as tds
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.models import unet as tunet
from instantrestore_tpu_torch.models import vae as tvae
from instantrestore_tpu_torch.ops import image_ops as timg
from instantrestore_tpu_torch.training import coach as tcoach_mod
from instantrestore_tpu_torch.training import optim as toptim
from instantrestore_tpu_torch.training.losses.composite import facial_comp_sizes

from test_torch_cold import B, N, RES, UCFG, VCFG, jax_draws
from test_torch_degrade import jax_cycle_noise
from test_torch_gan import TINY_VIT, jax_diff_augment_draws, tcfg as vit_tcfg
from test_torch_serving import random_tree

LOSS_REL, LOSS_ATOL, LEAF_ATOL, ACC_ATOL = 1e-5, 1e-6, 1e-5, 1e-6
# the cold and train-step tests' tiny widths with one layer a block (six
# shared layers): JAX's jit of its Coach's G step is most of this file's time
UCFG1, VCFG1 = (dataclasses.replace(c, layers_per_block=1) for c in (UCFG, VCFG))
J_STATICS = jrest.RestorerStatics(unet_cfg=UCFG1, vae_cfg=VCFG1, compute_dtype=jnp.float32,
                                  use_adain=True, train_input=True)
T_STATICS = trest.RestorerStatics(unet_cfg=tunet.UNetConfig(**UCFG1.__dict__),
                                  vae_cfg=tvae.VAEConfig(**VCFG1.__dict__),
                                  compute_dtype=torch.float32, use_adain=True, train_input=True)
# AdamW's first step (lr * g / (|g| + eps): +-lr wherever g is clear of
# eps) against JAX's: the G leaves' gradients come through two fp32 UNet
# pipelines, and an entry whose gradient is rounding noise may step the
# other way; every entry stays within twice the step, at most FLIP_SHARE of
# them differ by half a step or more, the rest within a relative RMS
G_STEP_REL_RMS, D_STEP_REL_RMS, FLIP_SHARE = 1e-2, 1e-3, 5e-3
# the port-only behaviour runs: the same tiny widths at 64 px
SMALL = 64
PARITY_OVERRIDES = [
    "compute.batch_size=2", "compute.workers=0", "compute.test_workers=0", "compute.seed=0",
    "data.dataset_type=face_restore", f"data.resolution={RES}",
    f"data.max_conditioning_images={N}", "log.log2wandb=false",
    "steps.max_steps=1", "steps.metric_interval=100", "steps.image_interval=100",
    "steps.val_interval=100", "steps.save_interval=100",
    "optim.lambda_lpips=1.0", "optim.lambda_id_loss=1.0", "optim.lambda_gan=0.5",
    "optim.lambda_cycle=1.0", "optim.lambda_facial_comp=0.5", "optim.lambda_attn_reg=0.1",
    "optim.lambda_pos_reg=0.1", "optim.lambda_neg_reg=0.1", "optim.lr_warmup_steps=0",
    "optim.learning_rate=1e-3", "optim.scheduler_type=constant",
    "model.lora_rank_unet=4", "model.lora_rank_vae=4", "model.use_adain=true",
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def _write_identities(root, rng, side, names, n_images, landmarks=True):
    for name in names:
        d = root / name
        (d / "cropped_images").mkdir(parents=True)
        (d / "new_landmarks").mkdir()
        for i in range(n_images):
            Image.fromarray(rng.integers(0, 255, (side, side, 3), np.uint8)).save(
                d / "cropped_images" / f"{i}.png")
            if landmarks:
                lm = rng.uniform(0.2 * side, 0.8 * side, (640, 2)).astype(np.float32)
                np.save(d / "new_landmarks" / f"{i}.npy", lm)


def _write_val(root, rng, side, n_ident):
    for i in range(n_ident):
        d = root / f"id{i}"
        (d / "conditioning").mkdir(parents=True)
        for name in ("degraded.png", "gt.png", "conditioning/c0.png"):
            Image.fromarray(rng.integers(0, 255, (side, side, 3), np.uint8)).save(d / name)


@pytest.fixture(scope="module")
def parity_roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("coach_parity")
    rng = np.random.default_rng(0)
    _write_identities(root / "train", rng, RES + 8, ("ann", "ben"), 3)
    _write_val(root / "val", rng, RES + 8, 1)
    return root


@pytest.fixture(scope="module")
def pair(parity_roots, tmp_path_factory):
    """The JAX Coach, its port twin on the same converted weights, and one
    collated batch of each package's RestoreDataset (equal bit for bit,
    ``tests/test_torch_data.py``)."""
    out = tmp_path_factory.mktemp("coach_parity_exp")
    over = PARITY_OVERRIDES + [f"data.data_root={parity_roots / 'train'}",
                               f"data.val_data_root={parity_roots / 'val'}",
                               f"log.exp_root={out}"]
    jparams = random_tree(lambda k: jrest.init_restorer_params(
        k, J_STATICS, lora_rank_unet=4, lora_rank_vae=4), jax.random.PRNGKey(0))
    lp = random_tree(jlpips.init_lpips_params, jax.random.PRNGKey(1), seed=3)
    lp["lins"] = [{"kernel": jnp.abs(l["kernel"]) * 0.05} for l in lp["lins"]]
    nets = {"lpips_params": lp,
            "arcface_params": random_tree(jid.init_arcface_params, jax.random.PRNGKey(0)),
            "disc_backbone": random_tree(jvit.init_vit_params, jax.random.PRNGKey(0), TINY_VIT)}
    start = _np(jparams)
    # batch_size 1 only sizes JAX's device mesh (one device: no SPMD partitioning to
    # compile); its steps take the collated batch of 2 below as the port's do
    jcfg_ = jcfg.load_config(None, over + ["log.exp_name=jax", "compute.batch_size=1"])
    jc = jcoach_mod.Coach(jcfg_, statics=J_STATICS, params=jparams, vit_cfg=TINY_VIT, **nets)
    heads0 = _np(jc.disc_heads)
    tc = tcoach_mod.Coach(tcfg.load_config(None, over + ["log.exp_name=port"]),
                          statics=T_STATICS, params=convert.from_jax_tree(start),
                          vit_cfg=vit_tcfg(TINY_VIT), device="cpu",
                          **{k: convert.from_jax_tree(_np(v)) for k, v in nets.items()})
    tcoach_mod._copy_into(tc.disc_heads, convert.from_jax_tree(heads0))
    idx = [0, 4]
    jbatch = jds.collate([jc.train_dataset[i] for i in idx])
    tbatch = tds.collate([tc.train_dataset[i] for i in idx])
    return dict(jc=jc, tc=tc, start=start, heads0=heads0, jbatch=jbatch, tbatch=tbatch)


def _crops(batch):
    return facial_comp_sizes(batch["image"].shape[1])


def jax_g_draws(rng, batch):
    """The draws of JAX's Coach ``g_step(rng)``: the forward's noise and
    timestep from r_fwd; the regularisers' layer and DiffAugment (the image,
    then each crop from fold_in(r_loss, i + 1)) from r_loss; the cycle's noise
    from r_cycle."""
    r_fwd, r_loss, r_cycle = jax.random.split(rng, 3)
    r_t = jrest._split_rng(r_fwd, 4)[3]
    t = J_STATICS.noise_timesteps[int(jax.random.randint(r_t, (), 0, 3))]
    gan = [jax_diff_augment_draws(r_loss, B, RES, RES)] + [
        jax_diff_augment_draws(jax.random.fold_in(r_loss, i + 1), B, h, w)
        for i, (h, w) in enumerate(_crops(batch))]
    return {"noise": jax_draws(r_fwd, B, N), "timestep": t,
            "layer_idx": int(jax.random.randint(r_loss, (), 0, UCFG1.num_shared_attn_layers)),
            "gan_draws": gan,
            "cycle_noise": jax_cycle_noise(r_cycle, timg.cycle_noise_shapes(B, RES, RES))}


def jax_d_draws(rng, batch):
    """The draws of JAX's Coach ``d_step(rng)``: r1 for the real image and
    fold_in(r1, i + 1) for its crops, r2 likewise for the fake."""
    r1, r2 = jax.random.split(rng)
    draws = [jax_diff_augment_draws(r, B, RES, RES) for r in (r1, r2)]
    for i, (h, w) in enumerate(_crops(batch)):
        draws += [jax_diff_augment_draws(jax.random.fold_in(r, i + 1), B, h, w) for r in (r1, r2)]
    return draws


@pytest.fixture(scope="module")
def g_step(pair):
    jc, tc = pair["jc"], pair["tc"]
    key = jax.random.PRNGKey(17)
    jdev, layer = jc._device_batch(pair["jbatch"])
    params, _, jlosses, jpred = jc._g_step(jc.params, jc.g_opt_state, jc.disc_heads, jdev, key,
                                           landmark_layer=layer)
    tdev, tlayer = tds.to_torch_batch(pair["tbatch"], "cpu")
    assert layer is None and tlayer is None
    tlosses, tpred = tc.g_step(tdev, None, jax_g_draws(key, pair["tbatch"]))
    return dict(jlosses=_np(jlosses), jpred=np.array(jpred), jparams=_np(params),
                tlosses={k: float(v) for k, v in tlosses.items()}, tpred=tpred.numpy())


G_TERMS = ["loss_l2", "loss_lpips", "loss_id", "sim_id", "loss_attn_reg", "loss_cycle",
           "loss_attn_pos_reg", "loss_attn_neg_reg", "loss_facial_comp_l2",
           "loss_facial_comp_lpips", "loss_g", "fc_loss_g", "loss"]


@pytest.mark.parametrize("term", G_TERMS)
def test_g_step_loss_terms_match_jax(g_step, term):
    jl, tl = g_step["jlosses"], g_step["tlosses"]
    assert set(G_TERMS) <= set(tl) and set(jl) <= set(tl)
    np.testing.assert_allclose(tl[term], float(jl[term]), rtol=LOSS_REL, atol=LOSS_ATOL,
                               err_msg=term)


def assert_first_adam_step(pairs, lr, rel_rms):
    """``pairs``: (name, port's leaf, JAX's leaf, the leaf before) of every
    trainable leaf after one AdamW step."""
    d_port = np.concatenate([(got - start).numpy().ravel() for _, got, _, start in pairs])
    d_jax = np.concatenate([(want - start).numpy().ravel() for _, _, want, start in pairs])
    gap = np.abs(d_port - d_jax)
    flipped = gap >= 0.5 * lr
    err = np.linalg.norm(gap[~flipped]) / np.linalg.norm(d_jax[~flipped])
    assert gap.max() <= 2 * lr * (1 + 1e-3), (gap.max() / lr, flipped.mean(), err)
    assert flipped.mean() <= FLIP_SHARE and err <= rel_rms, (flipped.mean(), err)
    moved = [name for name, got, want, start in pairs if not torch.equal(got, start)]
    assert len(moved) > 0.9 * len(pairs)


def test_g_step_updates_the_trainable_leaves_as_jax(pair, g_step):
    tc = pair["tc"]
    want = dict(_leaves(convert.from_jax_tree(g_step["jparams"])))
    start = dict(_leaves(convert.from_jax_tree(pair["start"])))
    trainable = {id(t) for t in toptim.trainable_leaves(tc.params, tc.g_mask)}
    pairs = []
    for name, got in _leaves(tc.params):
        if id(got) in trainable:
            pairs.append((name, got.detach(), want[name], start[name]))
        else:
            assert torch.equal(got, start[name]), name
    assert_first_adam_step(pairs, tc.cfg.optim.learning_rate, G_STEP_REL_RMS)
    # the restore's output image, as tests/test_torch_cold.py holds it
    np.testing.assert_allclose(g_step["tpred"], g_step["jpred"], rtol=0, atol=1e-3)


def _power_iterated(heads, n):
    """``heads`` with every u advanced by n power iterations on its own
    (unchanged) kernel, as n ``discriminate`` calls with update_sn leave it."""
    if isinstance(heads, dict):
        if "u" in heads:
            u = jnp.asarray(heads["u"])
            for _ in range(n):
                _, u = jgan._sn_apply(jnp.asarray(heads["kernel"]), u, True)
            return {**heads, "u": np.asarray(u)}
        return {k: _power_iterated(v, n) for k, v in heads.items()}
    if isinstance(heads, list):
        return [_power_iterated(v, n) for v in heads]
    return heads


def test_d_step_matches_jax(pair, g_step):
    """The D step on JAX's prediction, real images and facial crops: the loss
    and the heads after AdamW match JAX's Coach. The u vectors are the power
    iteration's (one per discriminate call, 8 here, on the step's own
    kernels), where JAX's Coach also adds the loss's gradient w.r.t. u
    (optax.masked passes a masked-out leaf's update through)."""
    jc, tc = pair["jc"], pair["tc"]
    key = jax.random.PRNGKey(23)
    jdev, _ = jc._device_batch(pair["jbatch"])
    heads0 = jax.tree_util.tree_map(jnp.asarray, pair["heads0"])
    jheads, _, jloss = jc._d_step(jax.tree_util.tree_map(jnp.array, heads0),
                                  jc.d_opt.init(heads0), jnp.asarray(g_step["jpred"]), jdev["gt"],
                                  jdev["facial_comp_boxes"], key)
    tdev, _ = tds.to_torch_batch(pair["tbatch"], "cpu")
    tloss = tc.d_step(torch.from_numpy(g_step["jpred"]), tdev["gt"], tdev["facial_comp_boxes"],
                      draws=jax_d_draws(key, pair["tbatch"]))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_REL)
    n_calls = 2 * (1 + len(_crops(pair["jbatch"])))
    want = dict(_leaves(convert.from_jax_tree(_np(jheads))))
    power = dict(_leaves(convert.from_jax_tree(_power_iterated(pair["heads0"], n_calls))))
    before = dict(_leaves(convert.from_jax_tree(pair["heads0"])))
    n_u = quirk = 0
    pairs = []
    for name, got in _leaves(tc.disc_heads):
        if name.endswith(".u"):
            n_u += 1
            np.testing.assert_allclose(got.numpy(), power[name].numpy(), rtol=0, atol=LEAF_ATOL,
                                       err_msg=name)
            quirk += float((want[name] - power[name]).abs().max()) > 1e-4
            if got.numel() > 1:
                assert not torch.equal(got, before[name]), name
        else:
            pairs.append((name, got, want[name], before[name]))
    assert n_u == 6 and quirk >= 1
    assert_first_adam_step(pairs, tc.cfg.optim.learning_rate, D_STEP_REL_RMS)
    assert not any(t.requires_grad for _, t in _leaves(tc.disc_heads))


# ---------------------------------------------------------------------------
# gradient accumulation against optax.MultiSteps
# ---------------------------------------------------------------------------


def test_accumulation_matches_optax_multisteps():
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 3), "b": (7,), "frozen": (4,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    mask = {"a": True, "b": True, "frozen": False}
    kw = dict(learning_rate=1e-2, lr_warmup_steps=0, adam_weight_decay=0.1, clip_grad_max_norm=0.5)
    jopt = optax.MultiSteps(joptim.make_optimizer(
        jcfg.OptimConfig(scheduler_type=jcfg.SchedulerType.COSINE, **kw), 4, mask), 2)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = toptim.make_optimizer(tcfg.OptimConfig(scheduler_type=tcfg.SchedulerType.COSINE, **kw),
                                 4, mask, accumulation_steps=2)
    jp, state = jax.tree_util.tree_map(jnp.asarray, params), None
    state = jopt.init(jp)
    for micro in range(4):
        g = {k: rng.normal(size=s).astype(np.float32) * (0.0 if k == "frozen" else 1.0)
             for k, s in shapes.items()}
        upd, state = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update(tp, [torch.from_numpy(g[k]) for k in ("a", "b")])
        assert topt.count == (micro + 1) // 2 and topt.mini_step == (micro + 1) % 2
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=ACC_ATOL,
                                       err_msg=f"{k} after micro-step {micro + 1}")
        adam = [s for s in jax.tree_util.tree_leaves(
            state.inner_opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]
        assert int(adam.count) == topt.count
        for i, k in enumerate(("a", "b")):
            np.testing.assert_allclose(topt.exp_avg[i].numpy(), np.asarray(adam.mu[k]),
                                       rtol=0, atol=ACC_ATOL)
            np.testing.assert_allclose(topt.exp_avg_sq[i].numpy(), np.asarray(adam.nu[k]),
                                       rtol=0, atol=ACC_ATOL)
            np.testing.assert_allclose(topt.acc_grads[i].numpy(),
                                       np.asarray(state.acc_grads[k]), rtol=0, atol=ACC_ATOL)
    assert torch.equal(tp["frozen"], torch.from_numpy(params["frozen"]))
