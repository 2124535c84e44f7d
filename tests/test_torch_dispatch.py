"""The Coach's multi-step dispatch (``compute.steps_per_dispatch`` > 1) on
the CPU, tiny widths at 64 px in fp32, where its static-buffer step runs
eagerly (on the card each step is one replay of a captured CUDA graph;
``chip_smoke.py --only dispatch``).

A dispatch run ends where the one-step run ends, bit for bit: trainable
leaves, discriminator heads and their ``u`` vectors, both optimizers'
moments and counts, and the steps at which metrics are logged; so does a
dispatch run resumed from a save that a dispatch crossed, and one under
gradient accumulation. The stacked batch is JAX's ``Coach._stack_batches``
(keys kept and dropped, landmark targets splatted again at the first
batch's layer), the intervals follow JAX's ``_after_steps`` crossing rule,
a device-tensor timestep restores as the int one does, and the static step
reads nothing back from the device (what a CUDA graph capture refuses).
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from instantrestore_tpu.training import coach as jcoach_mod
from instantrestore_tpu_torch.configs import config as tcfg
from instantrestore_tpu_torch.data import datasets as tds
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.training import coach as tcoach_mod
from instantrestore_tpu_torch.training.losses import id_loss as tid

from test_torch_coach import _leaves, _write_identities, one_thread  # noqa: F401
from test_torch_coach_port import SMALL, SMALL_STATICS, small_cfg, small_coach, small_roots  # noqa: F401


def run_coach(root, tmp_path, name, spd, **over):
    """A Coach of batch 2 over the 6 training items (3 batches an epoch, so
    4 steps wrap into the second epoch) trained to its max_steps."""
    kw = dict(compute__batch_size=2, steps__max_steps=4, steps__save_interval=2,
              steps__metric_interval=3, optim__lambda_lpips=0.0)
    kw.update(over)
    cfg = small_cfg(root, tmp_path, name, compute__steps_per_dispatch=spd, **kw)
    coach = small_coach(cfg)
    coach.train()
    return coach


def metric_steps(coach):
    log = (Path(coach.cfg.log.exp_dir) / "logs" / "log.txt").read_text()
    return [int(line.split("step ")[1].split(":")[0]) for line in log.splitlines()
            if ": train: " in line]


def state_parts(coach):
    """Every tensor of the trainer's state, by part."""
    def opt(o):
        return ([("count", torch.tensor(o.count)), ("mini_step", torch.tensor(o.mini_step))]
                + [(f"{k}.{i}", t) for k in ("exp_avg", "exp_avg_sq", "acc_grads")
                   for i, t in enumerate(getattr(o, k))])

    return {"leaves": _leaves(coach.params), "heads": _leaves(coach.disc_heads),
            "g_opt": opt(coach.g_opt), "d_opt": opt(coach.d_opt)}


def assert_same_state(got, want):
    for part, named in state_parts(want).items():
        mine = state_parts(got)[part]
        assert [n for n, _ in mine] == [n for n, _ in named], part
        for (name, a), (_, b) in zip(mine, named):
            assert torch.equal(a, b), f"{part}: {name}"


@pytest.fixture(scope="module")
def runs(small_roots, tmp_path_factory):
    out = tmp_path_factory.mktemp("dispatch")
    return {spd: run_coach(small_roots, out, f"spd{spd}", spd) for spd in (1, 2, 3)}


@pytest.mark.parametrize("part", ["leaves", "heads", "g_opt", "d_opt"])
@pytest.mark.parametrize("spd", [2, 3])
def test_dispatch_equals_the_one_step_run(runs, spd, part):
    """spd 2 (two dispatches of 2) and spd 3 (dispatches of 3 and 1) over 4
    steps: every tensor of ``part`` equals the one-step run's, bit for bit
    (heads include the power iteration's ``u``)."""
    want = state_parts(runs[1])[part]
    got = state_parts(runs[spd])[part]
    assert runs[spd].train_step_num == 4
    for (name, a), (_, b) in zip(got, want):
        assert torch.equal(a, b), name


def test_dispatch_logs_where_it_crosses_an_interval(runs):
    """Metric interval 3: the one-step run logs at 3, spd 2 at 4 (its
    dispatch crosses 3), spd 3 at 3; each logs the last step's losses."""
    assert metric_steps(runs[1]) == [3]
    assert metric_steps(runs[2]) == [4]
    assert metric_steps(runs[3]) == [3]
    saves = {spd: sorted(p.name for p in (Path(c.cfg.log.exp_dir) / "checkpoints").iterdir()
                         if p.name.startswith("step_")) for spd, c in runs.items()}
    assert saves == {1: ["step_2", "step_4"], 2: ["step_2", "step_4"], 3: ["step_3", "step_4"]}


def test_resume_across_a_dispatch_boundary_is_bit_exact(runs, small_roots, tmp_path):
    """The spd 3 run's full save at step 3 (its first dispatch crossed the
    save interval 2), resumed by a Coach of other weights at spd 2: one
    dispatch of 1 step from the second epoch ends where the one-step run
    ends."""
    base = runs[3].cfg
    cfg = copy.deepcopy(base)
    cfg.log.exp_name = "resumed"
    cfg.log.resume_from = str(Path(base.log.exp_dir) / "checkpoints" / "step_3")
    cfg.compute.steps_per_dispatch = 2
    b = small_coach(cfg, seed=123)
    assert b.train_step_num == 3 and b.g_opt.count == 3
    b.train()
    assert b.train_step_num == 4
    assert_same_state(b, runs[1])


def test_accumulation_under_a_dispatch(small_roots, tmp_path):
    """Two micro-steps a step under dispatches of 2 (two static steps, one
    per accumulation phase): ends where the one-step run ends."""
    kw = dict(optim__gradient_accumulation_steps=2, optim__lr_warmup_steps=0)
    eager = run_coach(small_roots, tmp_path, "acc1", 1, **kw)
    disp = run_coach(small_roots, tmp_path, "acc2", 2, **kw)
    assert disp.g_opt.count == 2 and disp.g_opt.mini_step == 0
    assert sorted(k[1] for k in disp._static_steps) == [False, True]
    assert_same_state(disp, eager)


# ---------------------------------------------------------------------------
# stacking and the crossing rule against JAX's Coach
# ---------------------------------------------------------------------------


class _Log:
    def __init__(self, rec, coach):
        self.rec, self.coach = rec, coach
        self.messages = []

    def log_message(self, msg):
        self.messages.append(msg)

    def update_step(self, step):
        pass

    def log_metrics(self, scalars, kind):
        self.rec.append(("metrics", self.coach.train_step_num))

    def vis_batch(self, name, images):
        self.rec.append(("images", self.coach.train_step_num))


def _bare(cls):
    coach = object.__new__(cls)
    coach.process_count, coach.group = 1, None
    coach.device = torch.device("cpu")
    coach.logger = _Log([], coach)
    return coach


def _collated(rng, layer, *, lm=True, coords=True, comps=True):
    """A collated batch of 2 at 64 px, as ``collate`` gives it."""
    b, res = 2, SMALL
    batch = {"image": rng.normal(size=(b, res, res, 3)).astype(np.float32),
             "gt": rng.normal(size=(b, res, res, 3)).astype(np.float32),
             "conditioning_images": rng.normal(size=(b, 2, res, res, 3)).astype(np.float32),
             "valid_indices": np.array([2, 1]),
             "degradation_params": {"noise_sigma": rng.uniform(size=b).astype(np.float32),
                                    "jpeg_quality": np.array([30, 60])}}
    if comps:
        batch["facial_comps"] = tuple(rng.uniform(size=(b, res, res)).astype(np.float32)
                                      for _ in range(3))
    if lm:
        heads, size = tds.SHARED_LAYER_STATS[layer]
        q = size * size
        batch["gt_attn_probs"] = (rng.uniform(size=(b, heads, q, q)).astype(np.float32),
                                  rng.uniform(size=(b, q)) > 0.5, layer, np.array([0, 1]))
    if coords:
        batch["landmark_coords"] = [
            (rng.uniform(0, res, (68, 2)).astype(np.float32),
             rng.uniform(0, res, (68, 2)).astype(np.float32)) for _ in range(b)]
    return batch


def _as_np(tree):
    if isinstance(tree, dict):
        return {k: _as_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_np(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}.{i}")
    else:
        assert got.dtype == np.asarray(want).dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("case", ["resplat", "partial_keys", "no_coords", "some_lack_targets"])
def test_stack_batches_matches_jax(case, monkeypatch):
    """The port's stack equals JAX's ``_stack_batches`` on the same collated
    batches (a bare JAX Coach, its sharding a no-op): the keys kept and
    dropped, the landmark layer, and the targets splatted again at the
    first batch's layer; the log messages are JAX's."""
    from instantrestore_tpu.parallel import mesh as jmesh

    monkeypatch.setattr(jmesh, "shard_stacked_batch", lambda mesh, tree: tree)
    rng = np.random.default_rng(5)
    kw = {"resplat": [{}, {}, {}],
          "partial_keys": [{}, {"comps": False}, {}],
          "no_coords": [{}, {"coords": False}],
          "some_lack_targets": [{}, {"lm": False}]}[case]
    batches = [_collated(rng, layer, **k) for layer, k in zip((1, 0, 2), kw)]
    jc, tc = _bare(jcoach_mod.Coach), _bare(tcoach_mod.Coach)
    jc.mesh = None
    jtree, jlayer = jc._stack_batches(batches)
    ttree, tlayer = tc._stack_batches(batches)
    assert tlayer == jlayer == (1 if case in ("resplat", "partial_keys") else None)
    _assert_tree_equal(_as_np(ttree), jax_tree_np(jtree))
    assert tc.logger.messages == jc.logger.messages
    if case == "resplat":  # the second and third batches were splatted again at layer 1
        want = tds.build_landmark_target(*batches[1]["landmark_coords"][0], 1, SMALL)[0]
        np.testing.assert_array_equal(_as_np(ttree)["gt_attn_probs"][1, 0], want)


def jax_tree_np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def test_after_steps_crossing_rule_matches_jax():
    """Dispatches of 2 with metric interval 3, image interval 5, validation
    at 4 and saves at 6: the port's ``_after_steps`` fires where JAX's does
    (metrics at 4 and 6, ...)."""
    cfg = tcfg.TrainConfig()
    cfg.steps.metric_interval, cfg.steps.image_interval = 3, 5
    cfg.steps.val_interval, cfg.steps.save_interval = 4, 6
    fired = {}
    for name, cls in (("jax", jcoach_mod.Coach), ("port", tcoach_mod.Coach)):
        c = _bare(cls)
        c.cfg, c.train_step_num, c._t0, c._steps_since_metric = cfg, 0, 0.0, 0
        rec = c.logger.rec
        c.validate = lambda c=c, rec=rec: rec.append(("val", c.train_step_num))
        c.save = lambda tag, full=False, c=c, rec=rec: rec.append(("save", c.train_step_num))
        batch = {"image": np.zeros((1, 4, 4, 3)), "gt": np.zeros((1, 4, 4, 3))}
        for _ in range(6):
            c._after_steps(2, {"loss": np.float32(1.0)}, torch.zeros(1, 4, 4, 3), batch)
        fired[name] = rec
    assert fired["port"] == fired["jax"]
    assert [s for k, s in fired["port"] if k == "metrics"] == [4, 6, 10, 12]


# ---------------------------------------------------------------------------
# what a capture needs
# ---------------------------------------------------------------------------


def test_restore_forward_takes_a_device_timestep():
    """A 0-d tensor timestep (the dispatch's draw, read on the device)
    restores bit for bit as the int does."""
    gen = torch.Generator().manual_seed(0)
    params = trest.init_restorer_params(gen, SMALL_STATICS, lora_rank_unet=4, lora_rank_vae=4)
    image = torch.rand((1, SMALL, SMALL, 3), generator=gen) * 2 - 1
    conds = torch.rand((1, 2, SMALL, SMALL, 3), generator=gen) * 2 - 1
    outs = []
    for t in (499, torch.tensor(499)):
        noise_gen = torch.Generator().manual_seed(1)
        outs.append(trest.restore_forward(params, image, conds, statics=SMALL_STATICS,
                                          timestep=t, generator=noise_gen, save_seg_sums=True))
    assert torch.equal(outs[0]["output_image"], outs[1]["output_image"])
    assert torch.equal(outs[0]["latent_pred"], outs[1]["latent_pred"])
    drawn = trest.restore_forward(params, image, conds, statics=SMALL_STATICS, timestep=None,
                                  generator=torch.Generator().manual_seed(1))["timestep"]
    assert isinstance(drawn, torch.Tensor) and int(drawn) in trest.NOISE_TIMESTEPS


# a captured step may not read a device value on the host, nor copy host
# memory to the device: the ops and functions that do either
HOST_READS = {"aten._local_scalar_dense.default", "aten.nonzero.default",
              "aten.masked_select.default", "aten._unique2.default",
              "aten.unique_consecutive.default", "aten.lift_fresh.default",
              "aten.lift_fresh_copy.default"}


class HostReadDetector(TorchDispatchMode):
    """Records every op of ``HOST_READS`` and every call that makes a tensor
    from host data (``torch.tensor``, ``torch.from_numpy``, ``torch.as_tensor``
    of a non-tensor, ``Tensor.numpy`` / ``tolist`` / ``cpu``)."""

    def __init__(self):
        super().__init__()
        self.seen = []
        self.patches = monkeypatch = pytest.MonkeyPatch()
        real_as_tensor = torch.as_tensor

        def flag(name, real):
            def f(*a, **k):
                self.seen.append(name)
                return real(*a, **k)
            return f

        def as_tensor(x, *a, **k):
            if not isinstance(x, torch.Tensor):
                self.seen.append("torch.as_tensor")
            return real_as_tensor(x, *a, **k)

        for name in ("tensor", "from_numpy"):
            monkeypatch.setattr(torch, name, flag(f"torch.{name}", getattr(torch, name)))
        monkeypatch.setattr(torch, "as_tensor", as_tensor)
        for name in ("numpy", "tolist", "cpu"):
            monkeypatch.setattr(torch.Tensor, name,
                                flag(f"Tensor.{name}", getattr(torch.Tensor, name)))

    def __exit__(self, *exc):
        self.patches.undo()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in HOST_READS:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("path", ["unfused", "fused_remat"])
def test_static_step_reads_nothing_from_the_host(path, tmp_path, monkeypatch):
    """Every loss term on (GAN and its facial crops, cycle, attention
    entropy, pos / neg regularisers, facial components; ID on aligned crops
    unfused, LPIPS through the kernel wrappers with remat, their plain
    versions here): the dispatch's static step, run again after its
    first run, makes no host read and no copy from host memory, once every constant
    exists on the device (the first run, which on the card precedes the
    capture, may make them)."""
    rng = np.random.default_rng(2)
    _write_identities(tmp_path / "train", rng, SMALL, ("a", "b"), 3)
    gen = torch.Generator().manual_seed(3)
    fused = path != "unfused"  # the ID term (IR-SE50) or LPIPS, the slow parts, in one case each
    cfg = small_cfg(tmp_path, tmp_path, "host", compute__batch_size=2,
                    compute__steps_per_dispatch=2, optim__lambda_id_loss=0.0 if fused else 1.0,
                    optim__lambda_lpips=0.5 if fused else 0.0,
                    optim__lambda_cycle=1.0, optim__lambda_facial_comp=0.5,
                    optim__lambda_attn_reg=0.1, optim__lambda_pos_reg=0.1,
                    optim__lambda_neg_reg=0.1, compute__fused_attention=fused,
                    compute__remat=fused)
    coach = small_coach(cfg, arcface_params=None if fused else tid.init_arcface_params(gen))
    batches = [tds.collate([coach.train_dataset[i] for i in idx]) for idx in ([0, 3], [1, 4])]
    keys = ("facial_comp_boxes", "degradation_params", "pos_reg_idx") + (
        () if fused else ("id_mats_pred",))
    assert all(k in batches[0] for k in keys)
    step = tcoach_mod._StaticStep.run
    seen = []

    def watched(self):
        with HostReadDetector() as det:
            out = step(self)
        seen.append(det.seen)
        return out

    monkeypatch.setattr(tcoach_mod._StaticStep, "run", watched)
    run_gen = torch.Generator()
    coach._t0, coach._steps_since_metric = 0.0, 0
    coach._run_dispatch(batches, run_gen)  # the first static step is made and run eagerly
    assert len(coach._static_steps) == 1 and coach.train_step_num == 2
    assert seen == [[]], seen


def test_train_entry_point_passes_steps_per_dispatch(small_roots, tmp_path, monkeypatch):
    """``cli.train`` with ``compute.steps_per_dispatch=2``: the Coach it
    builds runs its 2 steps as one dispatch."""
    from instantrestore_tpu_torch.cli import train as cli_train
    from test_torch_coach_port import SMALL_VIT

    dispatched = []
    run = tcoach_mod.Coach._run_dispatch
    monkeypatch.setattr(tcoach_mod.Coach, "_run_dispatch",
                        lambda self, batches, gen: dispatched.append(len(batches))
                        or run(self, batches, gen))
    argv = ["--device", "cpu", f"data.data_root={small_roots / 'train'}",
            f"data.val_data_root={small_roots / 'val'}", "data.dataset_type=face_restore",
            f"data.resolution={SMALL}", "data.max_conditioning_images=2", "steps.max_steps=2",
            "compute.batch_size=1", "compute.workers=0", "compute.test_workers=0",
            "compute.steps_per_dispatch=2", f"log.exp_root={tmp_path}", "log.exp_name=run",
            "log.log2wandb=false", "model.lora_rank_unet=4", "model.lora_rank_vae=4",
            "optim.lambda_lpips=0.0"]
    params = trest.init_restorer_params(torch.Generator().manual_seed(0), SMALL_STATICS,
                                        lora_rank_unet=4, lora_rank_vae=4)
    assert cli_train.main(argv, statics=SMALL_STATICS, params=params, vit_cfg=SMALL_VIT) == 0
    assert dispatched == [2]
    final = tcoach_mod.ckpt_mod.load_checkpoint(tmp_path / "run" / "checkpoints" / "final")
    assert final["step"] == 2 and final["cfg"]["compute"]["steps_per_dispatch"] == 2

