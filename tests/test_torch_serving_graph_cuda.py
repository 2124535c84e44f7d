"""The serving engine's CUDA graphs (``inference/serving.py``) on the card, at
tiny SD-Turbo- and SDXL-shaped widths (SDXL's per-level transformer depth
and added conditioning; every UNet attention at d = 64 and the VAE's mid
attention at 512, so that every hand-written kernel runs), warm and cold:

- a key's calls run eager, capture, replay, replay, and each is bit for bit
  the eager call, with the noise given and drawn from a generator;
- an output kept from one call is unchanged by the key's later replays;
- after ``onboard_one`` a replay reads the new row;
- under ``profiling.tracing()`` a replayed call's record has the eager
  call's stage and nested names and counts, with times of its own;
- the kernel counters after N replays are N eager calls'.

Needs an NVIDIA card: skips without one. This file imports no JAX, so it runs
without the repository's conftest there:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_graph_cuda.py``.
"""

import copy
import json
import os
from pathlib import Path

import pytest
import torch

from gpubench import weights
from gpubench.drivers import serve, serve_sdxl
from gpubench.reference import layout, sdxl
from instantrestore_tpu_torch.inference.serving import ServingEngine
from instantrestore_tpu_torch.models.restorer import serving_bundle
from instantrestore_tpu_torch.ops.flash_vjp import launch_counts, reset_launch_counts
from instantrestore_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

CONFIGS = Path(__file__).resolve().parent.parent / "gpubench" / "configs"
B, N, IDENT, LAT = 2, 2, 3, 16
TINY_VAE = dict(block_out_channels=[64, 128, 256, 512], norm_num_groups=32)
TINY_MODEL = dict(resolution=128, n_refs=N, lora_rank_unet=4, lora_rank_vae=4, dtype="bfloat16")


def _sd_turbo():
    cfg = json.loads((CONFIGS / "instantrestore-serve.json").read_text())
    cfg["unet"].update(sample_size=LAT, block_out_channels=[64, 128, 128, 128],
                       attention_head_dim=[1, 2, 2, 2], cross_attention_dim=64, norm_num_groups=32)
    return cfg, serve.statics_for, layout.restorer_layout, lambda cfg: serving_bundle


def _sdxl():
    cfg = json.loads((CONFIGS / "instantrestore-sdxl-turbo-serve.json").read_text())
    cfg["unet"].update(sample_size=LAT, block_out_channels=[64, 128, 128],
                       attention_head_dim=[1, 2, 2], cross_attention_dim=64, norm_num_groups=32,
                       transformer_layers_per_block=[1, 2, 3], addition_time_embed_dim=8,
                       projection_class_embeddings_input_dim=16 + 6 * 8)
    cfg["model"].update(time_ids=[112, 96, 8, 4, 128, 128])
    return cfg, serve_sdxl.statics_for, sdxl.restorer_layout, serve_sdxl.bundle_for


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); the CPU tests hold the engine's other paths")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def online():
    """The running-max attention, as every benchmark cell: under the seeded
    weights' peaky logits the default bound softmax returns NaN."""
    old = os.environ.get("INSTANTRESTORE_FLASH_ALGO")
    os.environ["INSTANTRESTORE_FLASH_ALGO"] = "online"
    yield
    if old is None:
        os.environ.pop("INSTANTRESTORE_FLASH_ALGO")
    else:
        os.environ["INSTANTRESTORE_FLASH_ALGO"] = old


@pytest.fixture(scope="module", params=["sd_turbo", "sdxl"])
def engine(request, card, online):
    cfg, statics_for, restorer_layout, bundle_for = {"sd_turbo": _sd_turbo, "sdxl": _sdxl}[
        request.param]()
    cfg = copy.deepcopy(cfg)
    cfg["vae"].update(TINY_VAE)
    cfg["model"].update(TINY_MODEL)
    statics = statics_for(cfg)
    scaling = serve.lora_scaling(cfg["model"]["lora_rank_unet"])
    with torch.no_grad():
        params = weights.materialize(restorer_layout(cfg), 11, card, lora_scaling=scaling)
        eng = ServingEngine(bundle_for(cfg)(params, statics), statics, device=card)
    g = torch.Generator().manual_seed(3)
    eng.refs = torch.randint(0, 256, (IDENT, N, 128, 128, 3), dtype=torch.uint8, generator=g)
    eng.onboard_noise = {k: torch.randn(IDENT, N, LAT, LAT, 4, generator=g).to(card)
                         for k in ("latent", "diffusion")}
    eng.onboard(eng.refs, noise=eng.onboard_noise)
    yield eng
    eng.close()


def _batch(card, seed: int):
    g = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (B, 128, 128, 3), dtype=torch.uint8, generator=g).pin_memory()
    refs = torch.randint(0, 256, (B, N, 128, 128, 3), dtype=torch.uint8, generator=g).pin_memory()
    noise = {k: torch.randn(rows, LAT, LAT, 4, generator=g).to(card) for k, rows in
             (("latent", B), ("diffusion", B), ("cond_latent", B * N), ("cond_diffusion", B * N))}
    return images, refs, noise


def _call(engine, path: str, draws: str, seed: int = 5):
    images, refs, noise = _batch(engine.device, seed)
    def kw():
        if draws == "generator":
            return {"generator": torch.Generator(device=engine.device).manual_seed(seed)}
        return {"noise": noise}

    if path == "warm":
        return lambda: engine.restore(images, torch.tensor([2, 0]), **kw())
    return lambda: engine.restore_cold(images, refs, **kw())


def _modes(engine, before):
    after = engine.graph_stats()
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("draws", ["noise", "generator"])
@pytest.mark.parametrize("path", ["warm", "cold"])
def test_replay_is_the_eager_call_bit_for_bit(engine, path, draws):
    engine._drop_graphs()
    call = _call(engine, path, draws)
    before = engine.graph_stats()
    outs = [call() for _ in range(4)]
    torch.cuda.synchronize()
    assert _modes(engine, before) == {"eager": 1, "captures": 1, "replays": 2}
    assert torch.isfinite(outs[0].float()).all()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    assert outs[3].data_ptr() != outs[2].data_ptr()


@pytest.mark.parametrize("path", ["warm", "cold"])
def test_a_kept_output_is_unchanged_by_later_replays(engine, path):
    engine._drop_graphs()
    first, second = _call(engine, path, "noise", 5), _call(engine, path, "noise", 6)
    kept = [first(), first(), first()]  # eager, capture, replay
    copies = [o.clone() for o in kept]
    other = [second(), second()]  # the same key: replays of other inputs
    torch.cuda.synchronize()
    assert all(torch.isfinite(o.float()).all() for o in copies + other)
    assert not torch.equal(other[0], copies[0])
    for o, c in zip(kept, copies):
        assert torch.equal(o, c)
    assert torch.equal(other[0], other[1])
    assert all(o.data_ptr() != kept[2].data_ptr() for o in other)


def test_a_replay_reads_the_row_onboard_one_wrote(engine):
    engine._drop_graphs()
    images, _, noise = _batch(engine.device, 7)
    ids = torch.tensor([0, 1])
    for _ in range(3):  # eager, capture, replay
        before = engine.restore(images, ids, noise=noise)
    row2 = {k: v[2] for k, v in engine.onboard_noise.items()}
    try:
        engine.onboard_one(engine.refs[2], 0, noise=row2)
        stats = engine.graph_stats()
        after = engine.restore(images, ids, noise=noise)
        assert engine.graph_stats()["replays"] == stats["replays"] + 1
        engine._drop_graphs()
        eager = engine.restore(images, ids, noise=noise)  # a plain forward of the new cache
        assert engine.graph_stats()["eager"] == stats["eager"] + 1
        assert torch.isfinite(after.float()).all()
        assert not torch.equal(after, before)
        assert torch.equal(after, eager)
    finally:
        engine.onboard_one(engine.refs[0], 0, noise={k: v[0] for k, v in
                                                     engine.onboard_noise.items()})


@pytest.mark.parametrize("path", ["warm", "cold"])
def test_a_replayed_record_has_the_eager_calls_spans(engine, path):
    engine._drop_graphs()
    call = _call(engine, path, "noise")
    profiling.reset()
    with profiling.tracing():
        for _ in range(4):
            call()
    recs = profiling.records()
    profiling.reset()
    assert [r["graph"] for r in recs] == ["eager", "capture", "replay", "replay"]
    eager = recs[0]
    assert eager["counts"].get("transformer", 0) > 0
    for r in recs[1:]:
        assert list(r["stages"]) == list(eager["stages"])
        assert sorted(r["nested"]) == sorted(eager["nested"])
        assert r["counts"] == eager["counts"]
        assert all(ms > 0 for ms in r["stages"].values())
        assert sum(r["stages"].values()) <= r["device_ms"]
    assert recs[2]["stages"] != recs[3]["stages"]  # each replay's own events


@pytest.mark.parametrize("path", ["warm", "cold"])
def test_replays_count_the_eager_calls_launches(engine, path):
    engine._drop_graphs()
    call = _call(engine, path, "noise")
    reset_launch_counts()
    call()  # eager
    torch.cuda.synchronize()
    one = {k: n for k, n in launch_counts().items() if n}
    assert one.get("group_norm", 0) > 0
    call()  # capture: its side-stream run counts, the capture does not
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    assert {k: n for k, n in launch_counts().items() if n} == {k: 5 * n for k, n in one.items()}
