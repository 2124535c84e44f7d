"""Training and serving across processes and devices: the port's
``parallel/distributed.py``, ``make_train_step(process_group=)``, the
multi-process Coach and ``cli.train --multihost``, and
``ServingEngine(devices=)``, on the CPU in fp32 at tiny widths.

Each multi-process case spawns two gloo ranks (``torch_parallel_worker.py``:
torch and the port only) over a ``file://`` store in the test's temporary
directory, with a 60 s collective timeout and a wall-clock limit on the
join, so a hung collective fails one test. The rank's batch and draws are its
rows of the global batch's (``local_rows``).

Tolerances: the 2-rank train step against JAX's on a 2-device CPU mesh as
``tests/test_torch_train_step.py`` holds one process to JAX: loss 1e-4;
params 2e-2 of the distance a leaf travelled, no entry farther than the
steps it took, and, as ``tests/test_torch_coach.py`` allows once the ID
term's IR-SE50 backward is in the gradient, at most ``FLIP_SHARE`` (0.5%)
of the entries off that (an entry whose gradient was rounding noise at one
step steps either way); the first moments as its gradients (1e-3 of a
leaf's largest entry plus 1e-7) and the second moments at 2e-3 of a leaf's
largest. Against the port's one process on the global batch the same rules
(the shares sum in another order than one mean). Ranks among themselves
and the multi-device cache against the one-device cache: bit for bit.
Served images: 1e-3 max-abs against JAX (as ``tests/test_torch_serving.py``),
1e-5 between the port's engines.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instantrestore_tpu.configs import config as jcfg
from instantrestore_tpu.inference import serving as jserving
from instantrestore_tpu.models import lora as jlora
from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu.parallel.mesh import make_mesh, replicate_params, shard_batch
from instantrestore_tpu.training import optim as joptim
from instantrestore_tpu.training import train_step as jstep
from instantrestore_tpu.training.losses import composite as jcomp
from instantrestore_tpu.training.losses import id_loss as jid
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.configs import config as tcfg
from instantrestore_tpu_torch.data.loader import DataLoader
from instantrestore_tpu_torch.inference import serving as tserving
from instantrestore_tpu_torch.inference import workers as tworkers
from instantrestore_tpu_torch.models import lora as tlora
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.models import unet as tunet
from instantrestore_tpu_torch.models import vae as tvae
from instantrestore_tpu_torch.ops import _build
from instantrestore_tpu_torch.ops import flash_vjp as tfv
from instantrestore_tpu_torch.ops import primitives as tprim
from instantrestore_tpu_torch.ops import shared_attention as tsa
from instantrestore_tpu_torch.parallel import distributed as pdist
from instantrestore_tpu_torch.training import coach as tcoach_mod
from instantrestore_tpu_torch.training import optim as toptim
from instantrestore_tpu_torch.training.losses import id_loss as tid

import torch_parallel_worker as W
from test_torch_cold import N, RES, UCFG, VCFG, cond_draws, engine_noise, jax_draws
from test_torch_serving import random_tree
from test_torch_coach import FLIP_SHARE
from test_torch_train_step import _mask, _np_tree

GB, STEPS, LR = 4, 2, 1e-3  # the global batch: two rows a rank
# the cold and train-step tests' tiny widths with one layer a block, to keep
# JAX's compiles on the mesh short
UCFG1, VCFG1 = (dataclasses.replace(c, layers_per_block=1) for c in (UCFG, VCFG))
J_STATICS = jrest.RestorerStatics(unet_cfg=UCFG1, vae_cfg=VCFG1, compute_dtype=jnp.float32,
                                  use_adain=True, train_input=False)
T_STATICS = trest.RestorerStatics(unet_cfg=tunet.UNetConfig(**UCFG1.__dict__),
                                  vae_cfg=tvae.VAEConfig(**VCFG1.__dict__),
                                  compute_dtype=torch.float32, use_adain=True, train_input=False)
OPT_KW = dict(lambda_l2=1.0, lambda_lpips=0.0, lambda_id_loss=1.0, lambda_pos_reg=0.1,
              lambda_neg_reg=0.1, learning_rate=LR, lr_warmup_steps=0)
# unequal counts across the ranks (rows 0-1 and 2-3): valid ID samples 2 | 1,
# valid pos targets 1 | 0, valid neg targets 2 | 1
ID_VALID = np.array([True, True, True, False])
POS_IDX = np.array([1, -1, -1, -1], np.int32)
NEG_IDX = np.array([0, 1, 1, -1], np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as ``tests/test_torch_coach.py``: beside the
    other test workers and the spawned ranks, more threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _leaves_tree(params, mask, leaves):
    """The trainable ``leaves`` (tree order) in a JAX tree of ``params``'s
    shape, zeros elsewhere, by JAX key path."""
    it = iter(leaves)
    tree = jax.tree_util.tree_map(lambda t, m: next(it) if m else torch.zeros_like(t),
                                  params, mask)
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(convert.to_jax_tree(tree))}


def _by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_moments_close(mu, nu, mu_ref, nu_ref):
    for k, r in mu_ref.items():
        np.testing.assert_allclose(mu[k], r, atol=1e-3 * np.abs(r).max() + 1e-7, err_msg=k)
        rn = nu_ref[k]
        np.testing.assert_allclose(nu[k], rn, atol=2e-3 * np.abs(rn).max() + 1e-12, err_msg=k)


def _assert_params_close(got, ref, start, steps, what):
    close = total = 0
    for k, r in ref.items():
        g, s = got[k], start[k]
        np.testing.assert_allclose(g, r, atol=2 * steps * LR, err_msg=f"{what} {k}")
        ok = np.abs(g - r) <= 2e-2 * np.abs(r - s) + 1e-7
        close += ok.sum()
        total += ok.size
    assert close / total > 1 - FLIP_SHARE, (what, close / total)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def test_collectives_on_two_ranks(tmp_path):
    r0, r1 = W.run_ranks(W.collectives, 2, tmp_path)
    for r, out in enumerate((r0, r1)):
        assert out["index"] == r and out["count"] == 2 and out["primary"] == (r == 0)
        torch.testing.assert_close(out["summed"][0], torch.full((3,), 3.0), rtol=0, atol=0)
        torch.testing.assert_close(out["summed"][1], torch.arange(5.0) * 3, rtol=0, atol=0)
        torch.testing.assert_close(out["summed"][2], torch.full((40,), 2.0), rtol=0, atol=0)
        assert out["nbytes"] == 4 * 48
        assert [b.tolist() for b in out["broadcast"]] == [[1, 1], [1.0] * 3, [1.0, 1.0]]
        assert out["broadcast"][2].dtype == torch.bfloat16
        assert "1 of 2" in out["raised"] and "'a'" in out["raised"]
    assert r0["rows"]["x"].tolist() == [0, 1] and r1["rows"]["x"].tolist() == [2, 3]
    assert r1["rows"]["refs"][0].tolist() == [4, 5, 6, 7] and r1["rows"]["none"] is None


def test_one_process_helpers():
    assert pdist.process_index() == 0 and pdist.process_count() == 1 and pdist.is_primary()
    assert pdist.default_group() is None
    x = torch.arange(6)
    assert pdist.local_rows(x, 6) is x
    assert pdist.local_rows(x, 3, rank=1, count=3).tolist() == [2, 3]
    with pytest.raises(ValueError, match="divide"):
        pdist.local_rows(x, 6, rank=0, count=4)
    pdist.barrier()
    pdist.check_replicas_agree([x])
    with pytest.raises(TypeError):
        pdist.all_reduce_sum_([x])


# ---------------------------------------------------------------------------
# the train step: 2 gloo ranks against JAX's on a 2-device mesh, and against
# the port's one process on the global batch with accumulation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_setup():
    params = random_tree(
        lambda k: jrest.init_restorer_params(k, J_STATICS, lora_rank_unet=4, lora_rank_vae=4),
        jax.random.PRNGKey(0))
    arcface = random_tree(jid.init_arcface_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(31)
    pts = [jid.ARCFACE_REFERENCE_POINTS_3 * (RES / 112) * s + o
           for s, o in ((0.8, 6.0), (0.9, -3.0), (0.85, 1.0), (0.95, 0.0))]
    mats = np.asarray(tid.alignment_transforms(pts, ref_points=tid.ARCFACE_REFERENCE_POINTS_3)[0],
                      np.float32)
    batch = {"image": rng.uniform(-1, 1, (GB, RES, RES, 3)).astype(np.float32),
             "gt": rng.uniform(-1, 1, (GB, RES, RES, 3)).astype(np.float32),
             "conditioning_images": rng.uniform(-1, 1, (GB, N, RES, RES, 3)).astype(np.float32),
             "valid_indices": np.array([N, 1, N, N], np.int32),
             "id_mats_pred": mats, "id_mats_target": mats, "id_valid": ID_VALID,
             "pos_reg_idx": POS_IDX, "neg_reg_idx": NEG_IDX}
    n_layers = J_STATICS.unet_cfg.num_shared_attn_layers
    layer_idx = int(jax.random.randint(jax.random.PRNGKey(0), (), 0, n_layers))
    return dict(params=_np_tree(params), arcface=_np_tree(arcface), batch=batch,
                layer_idx=layer_idx, mask=_mask(jlora, params))


@pytest.fixture(scope="module")
def jax_mesh_run(step_setup):
    """JAX's train step, batch sharded over a 2-device CPU mesh, for STEPS
    steps: per-step metrics, noise and timestep; the params and AdamW
    moments after them."""
    s = step_setup
    ocfg = jcfg.OptimConfig(scheduler_type=jcfg.SchedulerType.CONSTANT, **OPT_KW)
    opt = joptim.make_optimizer(ocfg, 100, s["mask"])
    arcface = jax.tree_util.tree_map(jnp.asarray, s["arcface"])

    def loss_fn(out, b, cfg):
        return jcomp.compute_generator_loss(out, b, cfg, rng=jax.random.PRNGKey(0),
                                            arcface_params=arcface, train_input=False)

    mesh = make_mesh(jax.devices()[:2])
    step = jax.jit(jstep.make_train_step(J_STATICS, ocfg, opt, s["mask"], loss_fn,
                                         save_attn_probs=True))
    p = replicate_params(mesh, jax.tree_util.tree_map(jnp.asarray, s["params"]))
    state = replicate_params(mesh, opt.init(p))
    jb = shard_batch(mesh, {k: jnp.asarray(v) for k, v in s["batch"].items()})
    steps = []
    for i in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(5), i)
        p, state, metrics, out = step(p, state, jb, key)
        # every input replicated or sharded as at the first call: one compile
        p, state = replicate_params(mesh, p), replicate_params(mesh, state)
        steps.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                          timestep=int(out["timestep"]), noise=jax_draws(key, GB, N)))
    adam = [x for x in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)]
    assert len(adam) == 1
    return dict(steps=steps, final=_by_path(_np_tree(p)), mu=_by_path(_np_tree(adam[0].mu)),
                nu=_by_path(_np_tree(adam[0].nu)))


def _spec(step_setup, steps, opt_kw=OPT_KW, **kw):
    ocfg = tcfg.OptimConfig(scheduler_type=tcfg.SchedulerType.CONSTANT, **opt_kw)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in step_setup["batch"].items()}
    return dict(params=step_setup["params"], arcface=step_setup["arcface"], ocfg=ocfg,
                statics=T_STATICS, layer_idx=step_setup["layer_idx"], batch=batch,
                steps=[dict(noise=s["noise"], timestep=s["timestep"]) for s in steps], **kw)


def _acc_spec(step_setup, jax_mesh_run):
    """The accumulation case: the same steps without the ID term (the parity
    case holds its counts), 2 micro-steps of one AdamW step."""
    return _spec(step_setup, jax_mesh_run["steps"], dict(OPT_KW, lambda_id_loss=0.0),
                 accumulation=2)


@pytest.fixture(scope="module")
def two_rank_steps(step_setup, jax_mesh_run, tmp_path_factory):
    """Both rank cases in one spawn: the JAX-parity run, then the
    accumulation run (a fresh start, 2 micro-steps of one AdamW step)."""
    parity = W.run_ranks(W.train_step_ranks, 2, tmp_path_factory.mktemp("ranks_parity"),
                         _spec(step_setup, jax_mesh_run["steps"]), timeout=180)
    acc = W.run_ranks(W.train_step_ranks, 2, tmp_path_factory.mktemp("ranks_acc"),
                      _acc_spec(step_setup, jax_mesh_run), timeout=180)
    return dict(parity=parity, acc=acc)


def test_two_rank_train_step_matches_jax_mesh(step_setup, jax_mesh_run, two_rank_steps):
    """Losses, params and moments after STEPS steps, with the ID term's and
    the regularisers' valid counts unequal across the ranks: each rank's
    terms take the global denominators."""
    r0, r1 = two_rank_steps["parity"]
    for a, b in zip(r0["leaves"] + r0["exp_avg"] + r0["exp_avg_sq"],
                    r1["leaves"] + r1["exp_avg"] + r1["exp_avg_sq"]):
        assert torch.equal(a, b)  # the ranks stay replicas
    assert r0["metrics"] == r1["metrics"]  # global metrics on every rank
    for j, t in zip(jax_mesh_run["steps"], r0["metrics"]):
        for k in ("loss", "loss_l2", "loss_id", "sim_id", "loss_attn_pos_reg",
                  "loss_attn_neg_reg"):
            np.testing.assert_allclose(t[k], j["metrics"][k], atol=1e-4, err_msg=k)
    assert r0["metrics"][0]["loss_attn_pos_reg"] > 0 and r0["metrics"][0]["loss_id"] > 0
    params = convert.from_jax_tree(step_setup["params"])
    mask = _mask(tlora, params)
    got = _leaves_tree(params, mask, r0["leaves"])
    start = _leaves_tree(params, mask, toptim.trainable_leaves(params, mask))
    ref = {k: jax_mesh_run["final"][k] for k in jax_mesh_run["mu"]}
    assert len(ref) == len(r0["leaves"]) > 400
    _assert_params_close(got, ref, start, STEPS, "params")
    _assert_moments_close(_leaves_tree(params, mask, r0["exp_avg"]),
                          _leaves_tree(params, mask, r0["exp_avg_sq"]),
                          jax_mesh_run["mu"], jax_mesh_run["nu"])


def test_two_rank_accumulation_matches_one_process(step_setup, jax_mesh_run, two_rank_steps):
    """Two micro-steps of accumulation on two ranks against the port's one
    process on the global batch: each micro-step's gradient is the summed
    global one, so the one applied step and its moments agree."""
    spec = _acc_spec(step_setup, jax_mesh_run)
    step, params, opt, mask = W.make_step(spec, None)
    start = [t.detach().clone() for t in toptim.trainable_leaves(params, mask)]
    for s in spec["steps"]:
        step(params, spec["batch"], noise=s["noise"], timestep=s["timestep"])
    assert opt.count == 1 and opt.mini_step == 0
    r0, r1 = two_rank_steps["acc"]
    for a, b in zip(r0["leaves"] + r0["exp_avg"], r1["leaves"] + r1["exp_avg"]):
        assert torch.equal(a, b)
    names = [str(i) for i in range(len(start))]

    def named(ts):
        return dict(zip(names, (t.detach().numpy() for t in ts)))

    _assert_moments_close(named(r0["exp_avg"]), named(r0["exp_avg_sq"]), named(opt.exp_avg),
                          named(opt.exp_avg_sq))
    _assert_params_close(
        dict(zip(names, (t.numpy() for t in r0["leaves"]))),
        dict(zip(names, (t.detach().numpy() for t in toptim.trainable_leaves(params, mask)))),
        dict(zip(names, (t.numpy() for t in start))), 1, "accumulated")


# ---------------------------------------------------------------------------
# the Coach and the train entry point on two ranks
# ---------------------------------------------------------------------------

COACH_RES, COACH_REFS = 64, 2


def _coach_cfg(root):
    cfg = tcfg.TrainConfig()
    cfg.compute.batch_size = cfg.compute.test_batch_size = 2
    cfg.compute.workers = cfg.compute.test_workers = 0
    cfg.data.resolution, cfg.data.max_conditioning_images = COACH_RES, COACH_REFS
    cfg.log.exp_root, cfg.log.exp_name, cfg.log.log2wandb = str(root), "run", False
    cfg.steps.max_steps = 2
    cfg.steps.metric_interval, cfg.steps.image_interval = 1, 100
    cfg.steps.val_interval, cfg.steps.save_interval = 100, 1
    cfg.optim.lambda_lpips = 0.0
    cfg.optim.lambda_gan = 0.5
    cfg.optim.lambda_pos_reg = cfg.optim.lambda_neg_reg = 0.1
    cfg.model.lora_rank_unet = cfg.model.lora_rank_vae = 4
    return cfg


def _coach_spec(roots):
    from test_torch_coach_port import SMALL_STATICS, SMALL_VIT

    return dict(cfg=_coach_cfg(roots[0]), roots=[str(r) for r in roots], statics=SMALL_STATICS,
                vit=SMALL_VIT, seed=0,
                datasets=(W.TinyFaces(6, 1, True, COACH_RES, COACH_REFS),
                          W.TinyFaces(5, 2, False, COACH_RES, COACH_REFS)))


def test_two_rank_coach_trains_as_one_process(tmp_path):
    """Coach.train() (2 G + D steps, a full save each step with the replica
    check, validation and the final save) on two ranks: rank 0 alone writes,
    the ranks end bit-identical, and the best validation loss and the
    logged train losses are those of one process over the same global
    batches (the 5-item test set: two full batches, the partial one dropped
    on both sides as a multi-process test loader must)."""
    roots = [tmp_path / "rank0", tmp_path / "rank1"]
    spec = _coach_spec(roots)
    r0, r1 = W.run_ranks(W.coach_ranks, 2, tmp_path, spec, timeout=180)
    assert r0["primary"] and not r1["primary"]
    assert r0["loader"] == (0, 2, True) and r1["loader"] == (1, 2, True)
    for name, t in r0["leaves"].items():
        assert torch.equal(t, r1["leaves"][name]), name
    for name, t in r0["heads"].items():
        assert torch.equal(t, r1["heads"][name]), name
    assert r0["best_val_loss"] == r1["best_val_loss"] < float("inf")
    rate = "steps_per_sec"  # each process's own clock
    assert [{k: v for k, v in m.items() if k != rate} for _, m in r0["logged"]] == \
        [{k: v for k, v in m.items() if k != rate} for _, m in r1["logged"]]
    exp = roots[0] / "run"
    for rel in ("logs/log.txt", "config.yaml", "checkpoints/final", "checkpoints/best_model",
                "checkpoints/step_1", "checkpoints/step_2", "checkpoints/timestep.txt"):
        assert (exp / rel).exists(), rel
    assert not roots[1].exists()  # rank 1 wrote nothing
    # one process over the same global batches (its test loader drops the
    # partial batch too, so that both see the same two)
    cfg = _coach_cfg(tmp_path / "one")
    one = tcoach_mod.Coach(cfg, statics=spec["statics"], params=W.tiny_params(spec),
                           vit_cfg=spec["vit"], datasets=spec["datasets"], device="cpu")
    one.test_loader.drop_last = True
    logged = []
    one.logger.log_metrics = lambda m, prefix="train": logged.append((prefix, dict(m)))
    one.train()
    np.testing.assert_allclose(r0["best_val_loss"], one.best_val_loss, rtol=1e-5)
    train = [m for p, m in logged if p == "train"]
    assert len(train) == 2
    for got, (_, ref) in zip(train, [x for x in r0["logged"] if x[0] == "train"]):
        for k in ("loss", "loss_l2", "loss_attn_pos_reg", "loss_attn_neg_reg", "loss_g",
                  "loss_d"):
            np.testing.assert_allclose(ref[k], got[k], rtol=1e-4, atol=1e-6, err_msg=k)
    leaves = dict(tcoach_mod._named_leaves(one.params))
    for name, t in r0["leaves"].items():
        np.testing.assert_allclose(t.detach().numpy(), leaves[name].detach().numpy(), rtol=0,
                                   atol=2 * 2 * cfg.optim.learning_rate, err_msg=name)


def test_train_entry_point_multihost_on_two_processes(tmp_path):
    """``cli.train --multihost`` with the coordinator flags on two CPU
    processes over PNG data through RestoreDataset: both exit 0 and leave
    the group, rank 0 writes the final checkpoint and rank 1 nothing."""
    from PIL import Image

    rng = np.random.default_rng(3)
    for split, names, n in (("train", ("a", "b"), 3), ("val", ("v",), 1)):
        for name in names:
            d = tmp_path / split / name / "cropped_images"
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 255, (80, 80, 3), np.uint8)).save(d / f"{i}.png")
    for name in ("v0", "v1"):
        d = tmp_path / "valset" / name
        (d / "conditioning").mkdir(parents=True)
        for f in ("degraded.png", "gt.png", "conditioning/c0.png"):
            Image.fromarray(rng.integers(0, 255, (80, 80, 3), np.uint8)).save(d / f)
    from test_torch_coach_port import SMALL_STATICS, SMALL_VIT

    roots = [tmp_path / "exp0", tmp_path / "exp1"]
    spec = dict(store=str(tmp_path / "cli_store"), roots=[str(r) for r in roots],
                statics=SMALL_STATICS, vit=SMALL_VIT, seed=0, overrides=[
                    "compute.batch_size=2", "compute.workers=0", "compute.test_workers=0",
                    f"data.data_root={tmp_path / 'train'}",
                    f"data.val_data_root={tmp_path / 'valset'}",
                    "data.dataset_type=face_restore", f"data.resolution={COACH_RES}",
                    "data.max_conditioning_images=2", "steps.max_steps=1",
                    "log.exp_name=cli", "log.log2wandb=false", "optim.lambda_lpips=0.0",
                    "model.lora_rank_unet=4", "model.lora_rank_vae=4"])
    r0, r1 = W.run_ranks(W.cli_ranks, 2, tmp_path, spec, timeout=120, join=False)
    assert r0 == r1 == {"rc": 0, "still_joined": False}
    final = tcoach_mod.ckpt_mod.load_checkpoint(roots[0] / "cli" / "checkpoints" / "final")
    assert final["step"] == 1
    assert not roots[1].exists()


def test_train_entry_point_gives_each_process_its_card(monkeypatch):
    """``cli.train --multihost`` with the coordinator flags and no torchrun
    environment on a node of four cards: each process id joins on its own
    card (the id modulo the cards), made current before the group is joined
    (NCCL binds its communicator to it), and the Coach trains there;
    ``--device cuda:N`` names the card instead."""
    from instantrestore_tpu_torch.cli import train as cli_train

    calls = []
    for var in ("LOCAL_RANK", "WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("current", torch.device(d))))
    monkeypatch.setattr(pdist.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(pdist.dist, "init_process_group",
                        lambda backend, **kw: calls.append(("join", backend, kw["rank"])))
    monkeypatch.setattr(pdist.dist, "destroy_process_group", lambda: calls.append(("leave",)))

    class FakeCoach:
        def __init__(self, cfg, *, statics=None, device=None, **kw):
            calls.append(("coach", torch.device(device)))

        def train(self):
            calls.append(("train",))

    monkeypatch.setattr(tcoach_mod, "Coach", FakeCoach)
    for pid, extra, card in [(i, [], i % 4) for i in range(8)] + [(5, ["--device", "cuda:2"], 2)]:
        monkeypatch.setattr(pdist, "_local_device_ids", None)
        calls.clear()
        argv = ["--multihost", "--coordinator_address", "localhost:29500", "--num_processes",
                "8", "--process_id", str(pid)] + extra
        assert cli_train.main(argv) == 0
        dev = torch.device("cuda", card)
        assert calls[:2] == [("current", dev), ("join", "nccl", pid)], (pid, calls)
        assert calls[-3:] == [("coach", dev), ("train",), ("leave",)], (pid, calls)
        assert {c[1] for c in calls if c[0] == "current"} == {dev}


# ---------------------------------------------------------------------------
# what needs no second process
# ---------------------------------------------------------------------------


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": i}


def test_loader_multi_process_errors():
    """JAX's rules (``tests/test_multihost.py``): the global batch divides
    evenly over the processes, and a multi-process loader drops the last
    partial batch."""
    collate = lambda items: items  # noqa: E731
    with pytest.raises(ValueError, match="divide evenly"):
        DataLoader(_Items(16), 7, process_count=2, collate_fn=collate)
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(_Items(16), 8, process_count=2, drop_last=False, collate_fn=collate)
    a, b = (DataLoader(_Items(10), 4, process_index=i, process_count=2, collate_fn=collate,
                       shuffle=False, num_workers=1) for i in (0, 1))
    assert [[x["i"] for x in batch] for batch in a] == [[0, 1], [4, 5]]
    assert [[x["i"] for x in batch] for batch in b] == [[2, 3], [6, 7]]


def test_coach_multi_process_checks(tmp_path, monkeypatch):
    """A global batch that does not divide over the processes raises, as in
    JAX's Coach, and so does WORLD_SIZE > 1 without a process group."""
    from test_torch_coach_port import SMALL_STATICS

    cfg = _coach_cfg(tmp_path)
    cfg.compute.batch_size = 3
    monkeypatch.setattr(pdist, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="divisible by the 2 processes"):
        tcoach_mod.Coach(cfg, statics=SMALL_STATICS, params={}, device="cpu")
    monkeypatch.undo()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="init_distributed"):
        tcoach_mod.Coach(cfg, statics=SMALL_STATICS, params={}, device="cpu")


def test_ranks_agree_on_batch_keys_and_landmark_layer(tmp_path, monkeypatch):
    """A rank's batch keeps only the keys every rank has (one all-reduce,
    here standing in for rank 0's contribution) and its landmark targets are
    splatted again at rank 0's layer, as collate does for one batch."""
    from instantrestore_tpu_torch.data import datasets as tds
    from test_torch_coach_port import SMALL_STATICS

    cfg = _coach_cfg(tmp_path)
    coach = tcoach_mod.Coach(cfg, statics=SMALL_STATICS, params=W.tiny_params(
        dict(statics=SMALL_STATICS, seed=0)), device="cpu",
        datasets=(W.TinyFaces(2, 1, True, COACH_RES, COACH_REFS),) * 2)
    coach.group, coach.process_count, coach.primary = object(), 2, False
    keys = tds.DEVICE_KEYS + ("gt_attn_probs",)
    rank0 = torch.tensor([float(k not in ("facial_comps", "facial_comp_boxes")) for k in keys]
                         + [3.0 + 1])  # rank 0: no facial components, landmark layer 3

    def other_rank(tensors, group):
        assert group is coach.group
        tensors[0] += rank0
        return 4 * tensors[0].numel()

    monkeypatch.setattr(pdist, "all_reduce_sum_", other_rank)
    rng = np.random.default_rng(5)
    coords = [(rng.uniform(0, 512, (20, 2)), rng.uniform(0, 512, (20, 2))) for _ in range(2)]
    own = [tds.build_landmark_target(g, c, 7, 512) for g, c in coords]
    host = {"image": np.zeros((2, 512, 512, 3), np.float32),
            "gt": np.zeros((2, 512, 512, 3), np.float32),
            "facial_comps": tuple(np.zeros((2, 512, 512), np.float32) for _ in range(3)),
            "facial_comp_boxes": np.zeros((2, 3, 2), np.int32),
            "gt_attn_probs": (np.stack([o[0] for o in own]), np.stack([o[1] for o in own]), 7,
                              np.zeros(2, np.int32)),
            "landmark_coords": coords}
    dev, layer = tds.to_torch_batch(host, "cpu")
    assert layer == 7
    dev, layer = coach._agree_on_batch(host, dev, layer)
    assert layer == 3 and "facial_comps" not in dev and "facial_comp_boxes" not in dev
    want = [tds.build_landmark_target(g, c, 3, 512) for g, c in coords]
    assert torch.equal(dev["gt_attn_probs"], torch.from_numpy(np.stack([w[0] for w in want])))
    assert torch.equal(dev["gt_attn_mask"], torch.from_numpy(np.stack([w[1] for w in want])))
    assert dev["gt_attn_mask"].any()


# ---------------------------------------------------------------------------
# ServingEngine(devices=) against JAX's ServingEngine(mesh=) and one device
# ---------------------------------------------------------------------------

IDS = np.array([2, 0, 3, 1])


@pytest.fixture(scope="module")
def serving():
    """Tiny models; JAX's engine on a 2-device mesh (unfused, its attention
    in plain XLA) onboards 4 identities and restores a batch of 4 warm and
    cold; the noise it drew is drawn again with its own key helpers."""
    params = random_tree(
        lambda k: jrest.init_restorer_params(k, J_STATICS, lora_rank_unet=4, lora_rank_vae=4),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(17)
    refs = rng.integers(0, 256, (4, N, RES, RES, 3), dtype=np.uint8)
    images = rng.integers(0, 256, (len(IDS), RES, RES, 3), dtype=np.uint8)
    conds = rng.integers(0, 256, (len(IDS), N, RES, RES, 3), dtype=np.uint8)
    bundle = jrest.serving_bundle(params, J_STATICS)
    onboard_rng, warm_rng, cold_rng = (jax.random.PRNGKey(i) for i in (41, 42, 43))
    jeng = jserving.ServingEngine(bundle, J_STATICS, use_fused_attention=False,
                                  mesh=make_mesh(jax.devices()[:2]))
    jeng.onboard(jnp.asarray(refs), onboard_rng)
    warm = np.asarray(jeng.restore(jnp.asarray(images), jnp.asarray(IDS), warm_rng))
    cold = np.asarray(jeng.restore_cold(jnp.asarray(images), jnp.asarray(conds), cold_rng))
    with pytest.raises(ValueError, match="divisible"):
        jeng.restore(jnp.asarray(images[:3]), jnp.asarray(IDS[:3]), warm_rng)
    tparams = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, params))
    return dict(
        torch=trest.serving_bundle(tparams, T_STATICS), refs=refs, images=images, conds=conds,
        jax_warm=warm, jax_cold=cold,
        onboard_noise=engine_noise([cond_draws(k, 1, N) for k in jax.random.split(onboard_rng, 4)]),
        warm_noise=jax_draws(jserving._per_sample_keys(warm_rng, len(IDS)), len(IDS)),
        cold_noise=jax_draws(jserving._per_sample_keys(cold_rng, len(IDS)), len(IDS), N))


@pytest.mark.parametrize("n_ident", [4, 3])
def test_multi_device_engine_matches_jax_mesh_and_one_device(serving, n_ident):
    """Two CPU 'devices': the onboarded cache (split over the devices with 4
    identities, onboarded on the first and copied with 3) is bit-equal to
    the one-device engine's and on each device; warm and cold restores
    match JAX's mesh engine and the one-device engine; a batch that does not
    divide raises."""
    tsa.reset_launch_counts()
    one = tserving.ServingEngine(serving["torch"], T_STATICS, device="cpu")
    with tserving.ServingEngine(serving["torch"], T_STATICS, devices=["cpu", "cpu"]) as two:
        assert two.devices == [torch.device("cpu")] * 2 and two.identity_cache
        refs = torch.from_numpy(serving["refs"][:n_ident])
        noise = {k: v[:n_ident] for k, v in serving["onboard_noise"].items()}
        c1, c2 = one.onboard(refs, noise=noise), two.onboard(refs, noise=noise)
        caches = two.device_caches()
        assert len(caches) == 2 and caches[0] is c2
        for cache in caches:  # the calling process's and the worker's own copy
            _assert_caches_equal(c1, cache)
        if n_ident == 4:
            _restores_match(serving, one, two)


def _assert_caches_equal(want, got):
    for a, b in zip(want, got, strict=True):
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def _restores_match(serving, one, two):
    images = torch.from_numpy(serving["images"])
    warm2 = two.restore(images, torch.from_numpy(IDS), noise=serving["warm_noise"])
    warm1 = one.restore(images, torch.from_numpy(IDS), noise=serving["warm_noise"])
    np.testing.assert_allclose(warm2.numpy(), serving["jax_warm"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(warm2.numpy(), warm1.numpy(), rtol=0, atol=1e-5)
    conds = torch.from_numpy(serving["conds"])
    cold2 = two.restore_cold(images, conds, noise=serving["cold_noise"])
    cold1 = one.restore_cold(images, conds, noise=serving["cold_noise"])
    np.testing.assert_allclose(cold2.numpy(), serving["jax_cold"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(cold2.numpy(), cold1.numpy(), rtol=0, atol=1e-5)
    assert not any(fn.launches for fn in tsa.KERNEL_WRAPPERS)
    with pytest.raises(ValueError, match="divisible"):
        two.restore(images[:3], torch.from_numpy(IDS[:3]), noise=serving["warm_noise"])
    with pytest.raises(ValueError, match="divisible"):
        two.restore_cold(images[:3], conds[:3], generator=torch.Generator().manual_seed(0))


def test_multi_device_draws_do_not_depend_on_the_device_count(serving):
    """With a generator and no noise, the multi-device engine draws the
    whole batch's noise in the one-device engine's order: the same outputs
    and the same cache from one seed on one device and on two."""
    outs = []
    for kw in (dict(device="cpu"), dict(devices=["cpu", "cpu"])):
        with tserving.ServingEngine(serving["torch"], T_STATICS, **kw) as eng:
            g = torch.Generator().manual_seed(7)
            cache = eng.onboard(torch.from_numpy(serving["refs"]), generator=g)
            images = torch.from_numpy(serving["images"])
            outs.append((cache, eng.restore(images, torch.from_numpy(IDS), generator=g),
                         eng.restore_cold(images, torch.from_numpy(serving["conds"]),
                                          generator=g)))
    (c1, w1, k1), (c2, w2, k2) = outs
    for a, b in zip(c1, c2):
        assert torch.equal(a.rk, b.rk) and torch.equal(a.kmax, b.kmax)
    torch.testing.assert_close(w2, w1, rtol=0, atol=1e-5)
    torch.testing.assert_close(k2, k1, rtol=0, atol=1e-5)


def test_multi_device_onboard_one_writes_every_device(serving):
    """``onboard_one`` writes its row into each device's cache (the worker
    process's own copy) and leaves every cache bit-equal to the one-device
    engine's after the same onboarding."""
    one = tserving.ServingEngine(serving["torch"], T_STATICS, device="cpu")
    with tserving.ServingEngine(serving["torch"], T_STATICS, devices=["cpu", "cpu"]) as two:
        refs = torch.from_numpy(serving["refs"])
        noise = serving["onboard_noise"]
        one.onboard(refs, noise=noise)
        two.onboard(refs, noise=noise)
        new = torch.from_numpy(serving["refs"][3])
        one_noise = {k: v[0] for k, v in noise.items()}
        before = two.device_caches()[1][0].rk[1].clone()
        one.onboard_one(new, 1, noise=one_noise)
        two.onboard_one(new, 1, noise=one_noise)
        caches = two.device_caches()
        for cache in caches:
            _assert_caches_equal(one.kv_cache, cache)
        assert not torch.equal(caches[1][0].rk[1], before)


def test_worker_exception_is_raised_in_the_caller_and_close_ends_the_workers(serving):
    """A worker's exception comes back as its own type with the worker's
    traceback as its cause, and the engine goes on serving; ``close()``
    leaves no child process, and ``with`` closes too."""
    import multiprocessing

    children = set(multiprocessing.active_children())
    eng = tserving.ServingEngine(serving["torch"], T_STATICS, devices=["cpu", "cpu"])
    pids = [w.proc.pid for w in eng._pool.workers]
    assert len(pids) == 1 and {p.pid for p in multiprocessing.active_children()} >= set(pids)
    eng.onboard(torch.from_numpy(serving["refs"]), noise=serving["onboard_noise"])
    images = torch.from_numpy(serving["images"])
    bad = {k: v[2:, :-1] for k, v in serving["warm_noise"].items()}
    with pytest.raises(ValueError, match="noise") as info:  # only the worker's rows are bad
        eng._pool.run("restore", [(images[2:], torch.from_numpy(IDS[2:]), bad)])
    assert isinstance(info.value.__cause__, tworkers.RemoteTraceback)
    assert "workers.py" in str(info.value.__cause__) and "restore_forward" in str(info.value.__cause__)
    out = eng.restore(images, torch.from_numpy(IDS), noise=serving["warm_noise"])
    np.testing.assert_allclose(out.numpy(), serving["jax_warm"], rtol=0, atol=1e-3)
    eng.close()
    assert set(multiprocessing.active_children()) == children
    eng.close()  # a second close is a no-op
    with tserving.ServingEngine(serving["torch"], T_STATICS, devices=["cpu", "cpu"]) as eng2:
        pid = eng2._pool.workers[0].proc.pid
    assert pid not in {p.pid for p in multiprocessing.active_children()}


def test_a_dead_worker_makes_every_later_call_raise(serving):
    """A worker killed between calls: the next call and every later one
    raise, naming the device; nothing is retried in the calling process."""
    with tserving.ServingEngine(serving["torch"], T_STATICS, devices=["cpu", "cpu"]) as eng:
        worker = eng._pool.workers[0]
        worker.proc.kill()
        worker.proc.join(30)
        refs = torch.from_numpy(serving["refs"])
        for _ in range(2):
            with pytest.raises(RuntimeError, match="worker for cpu is dead"):
                eng.onboard(refs, noise=serving["onboard_noise"])
        assert eng.kv_cache is None


def test_worker_launches_are_added_to_the_callers_counts():
    """The counts a worker reports are added to the wrappers' counts of the
    calling process, under the counters' lock."""
    tfv.reset_launch_counts()
    tfv.add_launch_counts({"shared_identity": 9, "flash_attention": 9})
    tfv.add_launch_counts({"flash_attention": 26})
    counts = tfv.launch_counts()
    assert counts["shared_identity"] == 9 and counts["flash_attention"] == 35
    assert sum(counts.values()) == 44
    tfv.reset_launch_counts()


def test_engine_takes_device_or_devices(serving):
    with pytest.raises(ValueError, match="not both"):
        tserving.ServingEngine(serving["torch"], T_STATICS, device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="empty"):
        tserving.ServingEngine(serving["torch"], T_STATICS, devices=[])


# ---------------------------------------------------------------------------
# the device guard of every kernel launch
# ---------------------------------------------------------------------------


def _fake_cuda_launches(monkeypatch):
    """Stand-ins for the card: ``torch.cuda.device`` records the device it
    makes current, the stream query and every C entry point record the
    current device they see. Returns the list of (entry point, device)."""
    seen, current = [], [torch.device("cuda", 0)]

    class device_ctx:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            self.prev = current[0]
            current[0] = self.dev

        def __exit__(self, *exc):
            current[0] = self.prev

    class Stream:
        cuda_stream = 0

    class Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, fn):
            def entry(*args):
                seen.append((fn, current[0]))
                return 0
            return entry

    monkeypatch.setattr(torch.cuda, "device", device_ctx)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(_build, "load", Lib)
    return seen


def test_launch_counts_lose_no_update_across_threads(monkeypatch):
    """Launches from many host threads at once (a caller's threads, and the
    serving engine adding its workers' counts): with more threads than cores
    and a short switch interval, every launch is counted once."""
    import sys
    import threading

    _fake_cuda_launches(monkeypatch)
    q = type("FakeTensor", (), {"device": torch.device("cuda", 0)})()
    tsa.reset_launch_counts()
    n_threads, per = 16, 500
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.launch(tsa.flash_online,
                                                                  "flash_online", q)
                                                    for _ in range(per)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    assert tsa.flash_online.launches == n_threads * per
    tsa.reset_launch_counts()


def test_every_kernel_launch_runs_under_its_tensors_device(monkeypatch):
    """All nine ctypes launch sites of the ten kernels, given tensors on
    cuda:1 (fake tensors: no card here) from a thread whose current device is
    0, call their C entry point with cuda:1 current, through the one helper
    ``_build.launch``; no kernel wrapper loads a library or calls an entry
    point itself."""
    import inspect
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    assert "load(" in inspect.getsource(_build.launch)
    for wrappers in (tsa, tfv, tprim):
        assert "load(" not in inspect.getsource(wrappers)
    seen = _fake_cuda_launches(monkeypatch)
    tfv.reset_launch_counts()
    bf, f32 = torch.bfloat16, torch.float32
    with FakeTensorMode(allow_non_fake_inputs=True), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # data_ptr() of a fake tensor
        dev = torch.device("cuda", 1)

        def t(*shape, dtype=bf):
            return torch.empty(shape, dtype=dtype, device=dev)

        b, h, sq, s, n, d = 2, 2, 128, 128, 2, 64
        q, k, v = t(b, h, sq, d), t(b, h, s, d), t(b, h, s, d)
        rk, rv = t(b, n, h, s, d), t(b, n, h, s, d)
        aff, kmax = t(b, h, n, 2, d, dtype=f32), t(b, h, dtype=f32)
        ids = torch.arange(b, device=dev)
        tsa.flash_attention(q, k, v, scale=0.125, algo="bound")
        tsa.flash_online(q, k, v, scale=0.125)
        tsa.shared_identity(q, rk, rv, aff, kmax, ids, scale=0.125)
        tsa.shared_flash_bound(q, k, v, rk, rv, aff, kmax, scale=0.125, include_input=True)
        tsa.shared_online(q, k, v, rk, rv, aff, scale=0.125, include_input=True)
        tsa.shared_online_pair(q, k, v, rk, rv, aff, scale=0.125, include_input=True)
        out, lse = tfv.flash_fwd_lse(q, k, v, scale=0.125)
        delta = t(b, h, sq, dtype=f32)
        tfv.flash_bwd_dq(q, k, v, q, lse, delta, scale=0.125)
        tfv.flash_bwd_dkv(q, k, v, q, lse, delta, scale=0.125)
        c = 64
        tprim.group_norm({"weight": t(c, dtype=f32), "bias": t(c, dtype=f32)}, t(b, 8, 8, c),
                         num_groups=32, in_bias=(t(c), t(b, c)), act="silu")
    names = [fn for fn, _ in seen]
    assert names == [f"irt_{s}_bf16" for s in (
        "flash_bound", "flash_online", "shared_identity", "shared_flash_bound", "shared_online",
        "shared_online_pair", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv", "group_norm")]
    assert all(d == torch.device("cuda", 1) for _, d in seen), seen
    assert all(fn.launches == 1 for fn in tfv.KERNEL_WRAPPERS)
    tfv.reset_launch_counts()
