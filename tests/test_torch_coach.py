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

Behaviour (the port alone, 64 px, as ``tests/test_coach.py`` tests the JAX
Coach): the smoke run, validation over the whole set with the visualisation
cap, the attention regularisers on every val batch, a full save and a resume
that ends bit for bit where the uninterrupted run ends, the overfit loss
going down, the refused multi-step dispatch, a multi-process launch that
has not joined a process group, the train entry point, and the Predictor
serving the trainer's ``final`` file (multi-process training itself:
``tests/test_torch_parallel.py``).
"""

import copy
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
from instantrestore_tpu_torch.inference.predictor import Predictor
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


# ---------------------------------------------------------------------------
# the port's Coach alone, as tests/test_coach.py tests the JAX one
# ---------------------------------------------------------------------------

SMALL_STATICS = T_STATICS
SMALL_VIT = vit_tcfg(jvit.ViTConfig(patch_size=14, embed_dim=64, depth=2, num_heads=4,
                                    mlp_ratio=2.0, pos_grid=16))


@pytest.fixture(scope="module")
def small_roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("coach_small")
    rng = np.random.default_rng(1)
    _write_identities(root / "train", rng, 96, ("a", "b"), 3, landmarks=False)
    _write_val(root / "val", rng, 96, 1)
    _write_val(root / "val3", rng, 80, 3)
    _write_val(root / "val7", rng, SMALL, 7)
    return root


def small_cfg(root, tmp_path, name, **over):
    cfg = tcfg.TrainConfig()
    cfg.compute.batch_size = cfg.compute.test_batch_size = 1
    cfg.compute.workers = 0
    cfg.compute.test_workers = 0
    cfg.data.data_root = str(root / "train")
    cfg.data.val_data_root = str(root / "val")
    cfg.data.dataset_type = "face_restore"
    cfg.data.resolution = SMALL
    cfg.data.max_conditioning_images = 2
    cfg.log.exp_root = str(tmp_path)
    cfg.log.exp_name = name
    cfg.log.log2wandb = False
    cfg.steps.max_steps = 2
    for k in ("metric_interval", "image_interval", "val_interval", "save_interval"):
        setattr(cfg.steps, k, 100)
    cfg.optim.lambda_lpips = 0.5
    cfg.optim.lambda_gan = 0.5
    cfg.model.lora_rank_unet = 4
    cfg.model.lora_rank_vae = 4
    for key, value in over.items():
        section, field = key.split("__")
        setattr(getattr(cfg, section), field, value)
    return cfg


def small_coach(cfg, seed=0, **kw):
    params = trest.init_restorer_params(torch.Generator().manual_seed(seed), SMALL_STATICS,
                                        lora_rank_unet=4, lora_rank_vae=4)
    return tcoach_mod.Coach(cfg, statics=SMALL_STATICS, params=params, vit_cfg=SMALL_VIT,
                            device="cpu", **kw)


LORA_PATH = "unet.up_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q.lora_B"


def _leaf(coach, path=LORA_PATH):
    return dict(_leaves(coach.params))[path]


def test_coach_smoke(small_roots, tmp_path):
    cfg = small_cfg(small_roots, tmp_path, "smoke", compute__workers=2, data__overfit=True,
                    steps__metric_interval=1, steps__image_interval=1, steps__val_interval=2)
    coach = small_coach(cfg)
    start = {k: v.clone() for k, v in _leaves(coach.params)}
    heads = {k: v.clone() for k, v in _leaves(coach.disc_heads)}
    coach.train()
    assert coach.train_step_num == 2
    trainable = {id(t) for t in toptim.trainable_leaves(coach.params, coach.g_mask)}
    for name, t in _leaves(coach.params):
        if id(t) not in trainable:
            assert torch.equal(t, start[name]), name
    assert not torch.equal(_leaf(coach), start[LORA_PATH])
    assert all(not torch.equal(t, heads[k]) for k, t in _leaves(coach.disc_heads)
               if not k.endswith(".u") or t.numel() > 1)
    exp = cfg.log.exp_dir
    for rel in ("logs/log.txt", "config.yaml", "checkpoints/final", "checkpoints/best_model",
                "checkpoints/timestep.txt", "logs/train_images/step_0000002.jpg",
                "logs/val_images/0000", "logs/val_attention/0000"):
        assert (exp / rel).exists(), rel
    log = (exp / "logs" / "log.txt").read_text()
    assert "loss_d=" in log and "loss_g=" in log and "val: " in log


def test_predictor_serves_the_final_checkpoint(small_roots, tmp_path):
    cfg = small_cfg(small_roots, tmp_path, "serve", data__overfit=True, steps__max_steps=1,
                    optim__lambda_gan=0.0)
    coach = small_coach(cfg)
    coach.train()
    final = cfg.log.exp_dir / "checkpoints" / "final"
    pred = Predictor(final, statics=SMALL_STATICS, dtype=torch.float32, resolution=SMALL,
                     device="cpu")
    assert torch.equal(dict(_leaves(pred.params))[LORA_PATH], _leaf(coach))
    rng = np.random.default_rng(3)
    out = pred.predict_batch(rng.uniform(-1, 1, (1, SMALL, SMALL, 3)).astype(np.float32),
                             rng.uniform(-1, 1, (1, 2, SMALL, SMALL, 3)).astype(np.float32))
    assert out.shape == (1, SMALL, SMALL, 3) and np.isfinite(out).all()


def test_validate_aggregates_whole_set_and_caps_vis(small_roots, tmp_path, monkeypatch):
    cfg = small_cfg(small_roots, tmp_path, "agg", data__val_data_root=str(small_roots / "val3"),
                    log__val_vis_count=0, log__vis_attention=False, optim__lambda_gan=0.0,
                    optim__lambda_lpips=0.0)
    coach = small_coach(cfg)
    calls = []
    orig = coach.eval_step
    monkeypatch.setattr(coach, "eval_step", lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    val_loss = coach.validate()
    assert len(calls) == 3 and np.isfinite(val_loss)
    vis = cfg.log.exp_dir / "logs" / "val_images"
    assert (vis / "0000").exists() and not (vis / "0001").exists()
    assert (cfg.log.exp_dir / "checkpoints" / "best_model").exists()
    assert "best val loss" in (cfg.log.exp_dir / "checkpoints" / "timestep.txt").read_text()
    # a second validation with the same weights is no better: no new best
    assert coach.validate() == val_loss


def test_validate_attn_reg_on_every_batch(small_roots, tmp_path, monkeypatch):
    cfg = small_cfg(small_roots, tmp_path, "valreg", data__val_data_root=str(small_roots / "val7"),
                    log__val_vis_count=2, optim__lambda_gan=0.0, optim__lambda_lpips=0.0,
                    optim__lambda_attn_reg=0.1)
    coach = small_coach(cfg)
    seen = []
    orig = coach.eval_step

    def spy(batch, draws, save_attn=False, save_stats=False):
        out = orig(batch, draws, save_attn=save_attn, save_stats=save_stats)
        seen.append((save_attn, save_stats, "loss_attn_reg" in out[0]))
        return out

    monkeypatch.setattr(coach, "eval_step", spy)
    assert np.isfinite(coach.validate())
    assert len(seen) == 7
    assert all(reg and stats for _, stats, reg in seen)
    assert [sa for sa, _, _ in seen] == [True] * 6 + [False]
    overlays = cfg.log.exp_dir / "logs" / "val_attention"
    assert sorted(p.name for p in overlays.iterdir()) == ["0000", "0001", "0002"]


def test_save_full_and_resume_is_bit_exact(small_roots, tmp_path):
    """An uninterrupted run of 4 steps (batch 2 of 6 items: the loader wraps
    into its second epoch) saves its full state at step 2; a fresh Coach of
    other weights resumed from it holds every tensor of that state bit for
    bit, and after 2 more steps ends where the uninterrupted run ends."""
    cfg = small_cfg(small_roots, tmp_path, "resume_a", compute__batch_size=2,
                    steps__max_steps=4, steps__save_interval=2,
                    optim__gradient_accumulation_steps=1, optim__lambda_lpips=0.0)
    a = small_coach(cfg)
    a.train()
    ckpt = cfg.log.exp_dir / "checkpoints" / "step_2"
    saved = tcoach_mod.ckpt_mod.load_checkpoint(ckpt)
    assert saved["full"] and saved["step"] == 2 and saved["g_opt"]["count"] == 2

    cfg2 = copy.deepcopy(cfg)
    cfg2.log.exp_name = "resume_b"
    cfg2.log.resume_from = str(ckpt)
    b = small_coach(cfg2, seed=123)
    assert b.train_step_num == 2 and b.g_opt.count == 2 and b.d_opt.count == 2
    for (name, got), (_, want) in zip(_leaves(b.params), _leaves(saved["params"])):
        assert torch.equal(got, want), name
    for (name, got), (_, want) in zip(_leaves(b.disc_heads), _leaves(saved["disc_heads"])):
        assert torch.equal(got, want), name
    for opt, key in ((b.g_opt, "g_opt"), (b.d_opt, "d_opt")):
        for got, want in zip(opt.exp_avg + opt.exp_avg_sq, saved[key]["exp_avg"]
                             + saved[key]["exp_avg_sq"]):
            assert torch.equal(got, want)
    b.train()
    assert b.train_step_num == 4
    for (name, got), (_, want) in zip(_leaves(b.params), _leaves(a.params)):
        assert torch.equal(got, want), name
    for (name, got), (_, want) in zip(_leaves(b.disc_heads), _leaves(a.disc_heads)):
        assert torch.equal(got, want), name
    for got, want in zip(b.g_opt.exp_avg_sq + b.d_opt.exp_avg,
                         a.g_opt.exp_avg_sq + a.d_opt.exp_avg):
        assert torch.equal(got, want)
    assert not torch.equal(_leaf(b), dict(_leaves(saved["params"]))[LORA_PATH])


def test_gradient_accumulation_moves_every_second_step(small_roots, tmp_path):
    cfg = small_cfg(small_roots, tmp_path, "accum", data__overfit=True,
                    optim__gradient_accumulation_steps=2, optim__lr_warmup_steps=0)
    coach = small_coach(cfg)
    gen = torch.Generator().manual_seed(0)
    batch = next(iter(coach.train_loader))
    dev, layer = tds.to_torch_batch(batch, "cpu")
    before = _leaf(coach).clone()
    heads_before = {k: v.clone() for k, v in _leaves(coach.disc_heads)}
    for micro in (1, 2):
        _, pred = coach.g_step(dev, layer, coach.draw_g(dev, gen))
        coach.d_step(pred, dev["gt"], None, draws=coach.draw_d(dev, gen))
        moved = not torch.equal(_leaf(coach), before)
        head_moved = not torch.equal(dict(_leaves(coach.disc_heads))["token_fc.weight"],
                                     heads_before["token_fc.weight"])
        assert moved == head_moved == (micro == 2), micro
        assert coach.g_opt.count == coach.d_opt.count == micro // 2


def test_overfit_loss_decreases(small_roots, tmp_path):
    """The G step on one batch with the same draws each time: the loss goes
    down (the reference's sanity check)."""
    cfg = small_cfg(small_roots, tmp_path, "overfit", data__overfit=True, optim__lambda_gan=0.0,
                    optim__lambda_lpips=0.0, optim__lambda_l2=1.0, optim__learning_rate=3e-3,
                    optim__lr_warmup_steps=0, optim__scheduler_type=tcfg.SchedulerType.CONSTANT)
    coach = small_coach(cfg)
    dev, layer = tds.to_torch_batch(next(iter(coach.train_loader)), "cpu")
    draws = dict(coach.draw_g(dev, torch.Generator().manual_seed(1)), timestep=249)
    losses = [float(coach.g_step(dev, layer, draws)[0]["loss"]) for _ in range(12)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) * 0.9, losses


def test_one_process_one_step_per_call(small_roots, tmp_path, monkeypatch):
    from instantrestore_tpu_torch.cli import train as cli_train

    cfg = small_cfg(small_roots, tmp_path, "spd", compute__steps_per_dispatch=2)
    with pytest.raises(ValueError, match="scanned dispatch.*Queue 5 item 4"):
        small_coach(cfg)
    # a multi-process run joins its group first: --multihost needs its rendezvous
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="coordinator_address"):
        cli_train.main(["--multihost", "--device", "cpu"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="init_distributed"):
        small_coach(small_cfg(small_roots, tmp_path, "ddp"))


def test_train_entry_point_runs_one_step(small_roots, tmp_path):
    from instantrestore_tpu_torch.cli import train as cli_train

    yaml_path = tmp_path / "train.yaml"
    yaml_path.write_text("compute:\n  batch_size: 1\n  workers: 0\n  test_workers: 0\n"
                         "optim:\n  lambda_lpips: 0.0\n  lambda_gan: 0.5\n")
    exp = tmp_path / "cli"
    argv = ["--config_path", str(yaml_path), "--device", "cpu",
            f"data.data_root={small_roots / 'train'}", f"data.val_data_root={small_roots / 'val'}",
            "data.dataset_type=face_restore", f"data.resolution={SMALL}",
            "data.max_conditioning_images=2", "steps.max_steps=1", f"log.exp_root={exp}",
            "log.exp_name=run", "log.log2wandb=false", "model.lora_rank_unet=4",
            "model.lora_rank_vae=4"]
    params = trest.init_restorer_params(torch.Generator().manual_seed(0), SMALL_STATICS,
                                        lora_rank_unet=4, lora_rank_vae=4)
    assert cli_train.main(argv, statics=SMALL_STATICS, params=params, vit_cfg=SMALL_VIT) == 0
    final = tcoach_mod.ckpt_mod.load_checkpoint(exp / "run" / "checkpoints" / "final")
    assert final["step"] == 1 and final["cfg"]["optim"]["lambda_lpips"] == 0.0
    assert not final["full"] and "disc_heads" in final and "g_opt" not in final
    assert "train: " not in (exp / "run" / "logs" / "log.txt").read_text()  # metric interval 10
