"""Rank processes for ``tests/test_torch_parallel.py``: torch and the port
only (no JAX), started with ``torch.multiprocessing``'s spawn context. Each
rank joins a gloo group over a ``file://`` store in the test's temporary
directory (no port to collide with under xdist), with a collective timeout,
and leaves its result in ``rank<i>.pt`` there."""

from __future__ import annotations

import datetime
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.parallel import distributed as pdist

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def _entry(fn, rank: int, world: int, root: str, join: bool, args) -> None:
    torch.set_num_threads(1)
    if join:
        pdist.init_distributed(f"file://{root}/store", world, rank, backend="gloo",
                               timeout=COLLECTIVE_TIMEOUT)
    try:
        torch.save(fn(rank, *args), Path(root) / f"rank{rank}.pt")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, root: Path, *args, timeout: float = 60.0, join: bool = True):
    """``fn(rank, *args)`` on ``world`` ranks, each in the gloo group (or
    left to join one itself, ``join=False``); returns their results in rank
    order. A rank that fails, or any still running ``timeout`` seconds of
    wall clock after the start, fails the call (and is killed)."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(root), join, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        if late:
            raise TimeoutError(f"ranks {late} still running after {timeout} s")
        bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if bad:
            raise RuntimeError(f"ranks failed (exit codes {bad})")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(Path(root) / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def collectives(rank: int):
    t = [torch.full((3,), float(rank + 1)), torch.arange(5.0) * (rank + 1), torch.ones(40)]
    pdist.BUCKET_BYTES = 40  # three buckets
    nbytes = pdist.all_reduce_sum_(t)
    b = [torch.full((2,), rank, dtype=torch.int64), torch.full((3,), float(rank)),
         torch.full((2,), rank, dtype=torch.bfloat16)]
    pdist.broadcast_(b, src=1)
    pdist.check_replicas_agree(b)
    raised = None
    try:
        pdist.check_replicas_agree([torch.tensor([float(rank)]), torch.ones(2)], ["a", "b"])
    except RuntimeError as e:
        raised = str(e)
    rows = pdist.local_rows({"x": torch.arange(4), "refs": [torch.arange(8)], "none": None}, 4)
    return dict(summed=t, nbytes=nbytes, broadcast=b, raised=raised, rows=rows,
                index=pdist.process_index(), count=pdist.process_count(),
                primary=pdist.is_primary())


# ---------------------------------------------------------------------------
# the train step across ranks
# ---------------------------------------------------------------------------


def train_step_ranks(rank: int, spec: dict):
    """The port's train step on this rank's rows of ``spec['batch']`` (the
    global batch), each step's global noise cut to its rows: the trainable
    leaves, the moments and the metrics after ``len(spec['steps'])`` steps."""
    from instantrestore_tpu_torch.training import optim as toptim

    step, params, opt, mask = make_step(spec, pdist.default_group())
    batch = pdist.local_rows(spec["batch"], spec["batch"]["gt"].shape[0])
    metrics = []
    for s in spec["steps"]:
        noise = pdist.local_rows(s["noise"], spec["batch"]["gt"].shape[0])
        m, _ = step(params, batch, noise=noise, timestep=s["timestep"])
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(leaves=[t.detach().clone() for t in toptim.trainable_leaves(params, mask)],
                exp_avg=[t.clone() for t in opt.exp_avg],
                exp_avg_sq=[t.clone() for t in opt.exp_avg_sq], metrics=metrics)


def make_step(spec: dict, group):
    """The port's train step of ``spec`` (statics, the JAX start tree as
    numpy, ArcFace's, the OptimConfig and the loss's layer) over ``group``."""
    from instantrestore_tpu_torch.models import lora as tlora
    from instantrestore_tpu_torch.training import optim as toptim
    from instantrestore_tpu_torch.training import train_step as tstep
    from instantrestore_tpu_torch.training.losses import composite as tcomp

    params = convert.from_jax_tree(spec["params"])
    arcface = convert.from_jax_tree(spec["arcface"])
    mask = {"unet": tlora.trainable_mask(params["unet"], extra_trainable=("conv_in",)),
            "unet_orig_conv_in": tlora.trainable_mask(params["unet_orig_conv_in"]),
            "vae": tlora.trainable_mask(params["vae"]), "caption_enc": False}
    ocfg = spec["ocfg"]
    opt = toptim.make_optimizer(ocfg, 100, mask, spec.get("accumulation", 1))

    def loss_fn(out, b, cfg, counts=None):
        return tcomp.compute_generator_loss(out, b, cfg, layer_idx=spec["layer_idx"],
                                            arcface_params=arcface, train_input=False,
                                            counts=counts)

    step = tstep.make_train_step(spec["statics"], ocfg, opt, mask, loss_fn,
                                 save_attn_probs=True, device="cpu", process_group=group)
    return step, params, opt, mask


# ---------------------------------------------------------------------------
# the Coach and the train entry point
# ---------------------------------------------------------------------------


class TinyFaces:
    """In-memory items of RestoreDataset's keys (``train``: pos / neg indices
    and aligned ID matrices, the valid flags and indices varying per item)
    or RestoreDatasetTest's, each a function of (seed, path index)."""

    def __init__(self, n: int, seed: int, train: bool, res: int, n_refs: int):
        from instantrestore_tpu_torch.training.losses import id_loss as id_mod

        self.paths, self.seed, self.train, self.res, self.n_refs = list(range(n)), seed, train, \
            res, n_refs
        pts = [id_mod.ARCFACE_REFERENCE_POINTS_3 * (res / 112) * s + o
               for s, o in ((0.85, 4.0), (0.95, -2.0))]
        self.mats = id_mod.alignment_transforms(pts, ref_points=id_mod.ARCFACE_REFERENCE_POINTS_3)[0]

    def __len__(self):
        return len(self.paths)

    def shuffle(self, seed=None):
        import random

        random.Random(seed).shuffle(self.paths)

    def __getitem__(self, idx):
        key = self.paths[idx]
        rng = np.random.default_rng([self.seed, key])

        def img(*shape):
            return rng.uniform(-1, 1, shape).astype(np.float32)

        item = {"image": img(self.res, self.res, 3), "gt": img(self.res, self.res, 3),
                "conditioning_images": img(self.n_refs, self.res, self.res, 3),
                "valid_indices": np.int32(self.n_refs - key % 2),
                "caption": "A high-quality photo of a person; professional, 8k"}
        if self.train:
            item.update(pos_reg_idx=np.int32(key % self.n_refs if key % 3 else -1),
                        neg_reg_idx=np.int32(-1 if key % 4 == 1 else (key + 1) % self.n_refs),
                        id_mat=self.mats[key % 2], id_valid=key % 3 != 2)
        else:
            item["identity"] = f"id{key}"
        return item


def coach_ranks(rank: int, spec: dict):
    """Coach.train() on this rank (its own exp_root, so that what it writes
    is seen apart): the trainable leaves and heads after it, the best
    validation loss and the train metrics it logged."""
    import copy

    from instantrestore_tpu_torch.training import coach as coach_mod

    cfg = copy.deepcopy(spec["cfg"])
    cfg.log.exp_root = spec["roots"][rank]
    coach = coach_mod.Coach(cfg, statics=spec["statics"], params=tiny_params(spec),
                            vit_cfg=spec["vit"], arcface_params=spec.get("arcface"),
                            datasets=spec["datasets"], device="cpu")
    seen = []
    log_metrics = coach.logger.log_metrics
    coach.logger.log_metrics = lambda m, prefix="train": (seen.append((prefix, dict(m))),
                                                          log_metrics(m, prefix))
    coach.train()
    trainable = {id(t) for t in coach_mod.trainable_leaves(coach.params, coach.g_mask)}
    return dict(leaves={n: t.clone() for n, t in coach_mod._named_leaves(coach.params)
                        if id(t) in trainable},
                heads={n: t.clone() for n, t in coach_mod._named_leaves(coach.disc_heads)},
                best_val_loss=coach.best_val_loss, logged=seen, primary=coach.primary,
                loader=(coach.train_loader.process_index, coach.train_loader.process_count,
                        coach.test_loader.drop_last))


def coach_ranks_each(rank: int, specs: list):
    """``coach_ranks`` for each spec in turn, in one process group."""
    return [coach_ranks(rank, spec) for spec in specs]


def tiny_params(spec: dict):
    from instantrestore_tpu_torch.models import restorer as trest

    return trest.init_restorer_params(torch.Generator().manual_seed(spec["seed"]),
                                      spec["statics"], lora_rank_unet=4, lora_rank_vae=4)


def cli_ranks(rank: int, spec: dict):
    """``cli.train.main --multihost`` on this rank, which joins the group
    itself: its exit code and whether it is left in a group."""
    from instantrestore_tpu_torch.cli import train as cli_train

    argv = ["--multihost", "--coordinator_address", f"file://{spec['store']}",
            "--num_processes", "2", "--process_id", str(rank), "--device", "cpu"]
    argv += spec["overrides"] + [f"log.exp_root={spec['roots'][rank]}"]
    rc = cli_train.main(argv, statics=spec["statics"], params=tiny_params(spec),
                        vit_cfg=spec["vit"])
    return dict(rc=rc, still_joined=dist.is_initialized())
