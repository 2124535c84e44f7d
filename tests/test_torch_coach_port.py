"""The port's trainer alone, at tiny widths at 64 px on the CPU in fp32, as
``tests/test_coach.py`` tests the JAX Coach (its parity with the JAX Coach:
``tests/test_torch_coach.py``).

Behaviour (the port alone, 64 px, as ``tests/test_coach.py`` tests the JAX
Coach): the smoke run, validation over the whole set with the visualisation
cap, the attention regularisers on every val batch, a full save and a resume
that ends bit for bit where the uninterrupted run ends, the overfit loss
going down, the multi-step dispatch, a multi-process launch that
has not joined a process group, the train entry point, and the Predictor
serving the trainer's ``final`` file (multi-process training itself:
``tests/test_torch_parallel.py``).
"""

import copy

import numpy as np
import pytest
import torch

from instantrestore_tpu.models import vit as jvit
from instantrestore_tpu_torch.configs import config as tcfg
from instantrestore_tpu_torch.data import datasets as tds
from instantrestore_tpu_torch.inference.predictor import Predictor
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.training import coach as tcoach_mod
from instantrestore_tpu_torch.training import optim as toptim

from test_torch_coach import SMALL, T_STATICS, _leaves, _write_identities, _write_val, one_thread  # noqa: F401
from test_torch_gan import tcfg as vit_tcfg

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

    # several steps a dispatch: one static step, run twice (tests/test_torch_dispatch.py)
    coach = small_coach(small_cfg(small_roots, tmp_path, "spd", compute__steps_per_dispatch=2))
    coach.train()
    assert coach.train_step_num == 2 and len(coach._static_steps) == 1
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
