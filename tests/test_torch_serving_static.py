"""The serving engine's static calls (``inference/serving.py``) on the CPU at
tiny widths, where no graph is captured: what a call's key holds, when the
static calls are dropped, that calls with a generator give the plain
forward's outputs bit for bit through the static buffers, that outputs are
fresh tensors, and that every call reads ``eager``. The capture's pieces
(``profiling.cuts``) and a replay's spans between them are held here with
stand-in graphs; the card test (``test_torch_serving_graph_cuda.py``)
replays real ones.
"""

import gc
import weakref

import pytest
import torch

from instantrestore_tpu_torch.inference.serving import ServingEngine, _maybe_preprocess, _StaticCall
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.models import unet as tunet
from instantrestore_tpu_torch.models import vae as tvae
from instantrestore_tpu_torch.ops.shared_attention import IdentityRef
from instantrestore_tpu_torch.utils import profiling

STATICS = trest.RestorerStatics(
    unet_cfg=tunet.UNetConfig(sample_size=8, block_out_channels=(32, 64, 64, 64),
                              attention_heads=(1, 2, 2, 2), cross_attention_dim=16,
                              norm_num_groups=8),
    vae_cfg=tvae.VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4),
    use_adain=True, train_input=False, compute_dtype=torch.float32)
RES, B, N_REFS, N_IDENT = 64, 2, 2, 3
IDS = torch.tensor([2, 0])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (as ``tests/test_torch_serving.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def empty_ring():
    profiling.reset()
    yield
    profiling.reset()


def _params():
    return trest.serving_bundle(trest.init_restorer_params(
        torch.Generator().manual_seed(0), STATICS, lora_rank_unet=4, lora_rank_vae=4), STATICS)


def _refs(seed: int = 1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (N_IDENT, N_REFS, RES, RES, 3), dtype=torch.uint8, generator=gen)


@pytest.fixture(scope="module")
def engine():
    eng = ServingEngine(_params(), STATICS, device="cpu")
    eng.onboard(_refs(), generator=torch.Generator().manual_seed(1))
    return eng


def _photos(seed: int = 2, b: int = B):
    gen = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (b, RES, RES, 3), dtype=torch.uint8, generator=gen)
    refs = torch.randint(0, 256, (b, N_REFS, RES, RES, 3), dtype=torch.uint8, generator=gen)
    return images, refs


def _gen():
    return torch.Generator().manual_seed(9)


def _parent(engine, path: str, images, refs):
    """The restore as a plain forward draws it from a generator (the
    engine's code before its static calls)."""
    res, gen = engine.resolution, _gen()
    imgs = _maybe_preprocess(images, res)
    if path == "warm":
        ref_kv = [IdentityRef(c, IDS) for c in engine.kv_cache]
        out = trest.restore_forward(
            engine.params, imgs, statics=STATICS, timestep=engine.timestep,
            precomputed_ref_kv=ref_kv, generator=gen, use_fused_attention=True)
    else:
        conds = _maybe_preprocess(refs.reshape(B * N_REFS, RES, RES, 3), res)
        out = trest.restore_forward(
            engine.params, imgs, conds.reshape(B, N_REFS, res, res, 3), statics=STATICS,
            timestep=engine.timestep, generator=gen, use_fused_attention=True)
    return out["output_image"]


def _call(engine, path: str, images, refs, **kw):
    if path == "warm":
        return engine.restore(images, IDS, **kw)
    return engine.restore_cold(images, refs, **kw)


@pytest.mark.parametrize("path", ["warm", "cold"])
def test_generator_calls_are_the_plain_forward_bit_for_bit(engine, path):
    engine._drop_graphs()
    images, refs = _photos()
    want = _parent(engine, path, images, refs)
    before = engine.graph_stats()
    outs = [_call(engine, path, images, refs, generator=_gen()) for _ in range(3)]
    after = engine.graph_stats()
    assert len(engine._static) == 1  # calls 2 and 3 ran over the static buffers
    assert after["eager"] - before["eager"] == 3
    assert (after["captures"], after["replays"]) == (before["captures"], before["replays"])
    for out in outs:
        assert torch.equal(out, want)


@pytest.mark.parametrize("path", ["warm", "cold"])
def test_a_kept_output_is_unchanged_by_later_calls(engine, path):
    engine._drop_graphs()
    images, refs = _photos(3)
    first = _call(engine, path, images, refs, generator=_gen())
    kept = first.clone()
    others = [_call(engine, path, *_photos(4 + i), generator=_gen()) for i in range(2)]
    assert torch.equal(first, kept)
    assert not torch.equal(others[0], kept)
    assert others[0].data_ptr() != others[1].data_ptr()


def _drawn(engine):
    side = engine._latent_side()
    return {k: torch.randn(B, side, side, 4, generator=torch.Generator().manual_seed(i))
            for i, k in enumerate(("latent", "diffusion"))}


@pytest.mark.parametrize("change", ["shape", "noise_keys", "spans", "flash_algo"])
def test_each_change_gives_a_new_key(engine, change, monkeypatch):
    engine._drop_graphs()
    images, refs = _photos()
    base = lambda: engine.restore(images, IDS, generator=_gen())  # noqa: E731
    base(), base()
    keys = set(engine._static)
    if change == "shape":
        other = lambda: engine.restore(images[:1], IDS[:1], generator=_gen())  # noqa: E731
    elif change == "noise_keys":
        other = lambda: engine.restore(images, IDS, noise=_drawn(engine))  # noqa: E731
    elif change == "spans":
        def other():
            with profiling.tracing():
                return base()
    else:
        monkeypatch.setenv("INSTANTRESTORE_FLASH_ALGO", "online")
        other = base
    other(), other()
    new = set(engine._static) - keys
    assert len(new) == 1
    (old,), (key,) = keys, new
    # (key but for the span state, span state): the path, input shapes, noise
    # keys and INSTANTRESTORE_* variables are its first four entries
    changed = {"shape": old[0][1] != key[0][1], "noise_keys": old[0][2] != key[0][2],
               "spans": old[1] != key[1], "flash_algo": old[0][3] != key[0][3]}
    assert [k for k, v in changed.items() if v] == [change]


def test_onboard_drops_the_static_calls(engine):
    images, _ = _photos()
    for _ in range(2):
        engine.restore(images, IDS, generator=_gen())
    assert engine._static and engine._warmed
    engine.onboard(_refs(), generator=torch.Generator().manual_seed(1))
    assert not engine._static and not engine._warmed
    before = engine.graph_stats()["eager"]
    engine.restore(images, IDS, generator=_gen())
    assert engine.graph_stats()["eager"] == before + 1 and not engine._static


def test_an_engine_nothing_holds_is_freed_at_once():
    """No reference cycle through the static calls: the engine, its buffers
    and (on the card) its graphs go with the last reference, not at the
    next cyclic collection."""
    eng = ServingEngine(_params(), STATICS, device="cpu")
    eng.onboard(_refs(), generator=torch.Generator().manual_seed(1))
    images, refs = _photos()
    for _ in range(2):
        eng.restore(images, IDS, generator=_gen())
        eng.restore_cold(images, refs, generator=_gen())
    assert len(eng._static) == 2
    gone = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert gone() is None
    finally:
        gc.enable()


def test_calibrate_int8_runs_eagerly_and_drops_the_static_calls():
    eng = ServingEngine(_params(), STATICS, device="cpu", int8_decoder=True, int8_unet=True)
    eng.onboard(_refs(), generator=torch.Generator().manual_seed(1))
    images, _ = _photos()
    for _ in range(2):
        eng.restore(images, IDS, generator=_gen())
    (key,) = eng._static
    stats = eng.graph_stats()
    assert eng.calibrate_int8([(images, IDS, _gen())]) > 0
    assert not eng._static and not eng._warmed
    assert eng.graph_stats()["eager"] == stats["eager"] + 1  # the calibration batch
    for _ in range(2):
        out = eng.restore(images, IDS, generator=_gen())
    (new,) = eng._static
    assert new != key and new[0][4] == key[0][4] + 1  # the calibration state
    assert torch.isfinite(out).all()


def test_every_call_reads_eager_off_the_card(engine):
    images, refs = _photos()
    before = engine.graph_stats()
    with profiling.tracing():
        for _ in range(3):
            engine.restore(images, IDS, generator=_gen())
            engine.restore_cold(images, refs, generator=_gen())
    after = engine.graph_stats()
    assert after["eager"] - before["eager"] == 6
    assert (after["captures"], after["replays"]) == (before["captures"], before["replays"])
    assert [r["graph"] for r in profiling.records()] == ["eager"] * 6


# ---------------------------------------------------------------------------
# the capture's pieces and a replay's spans, with stand-in graphs
# ---------------------------------------------------------------------------


def test_spans_under_cuts_call_the_hook_and_record_nothing(engine):
    """What a capture in pieces sees of a cold forward: a boundary at every
    stage and nested span, in the eager record's order, with the counts."""
    images, refs = _photos()
    events = []
    with profiling.tracing():
        engine.restore_cold(images, refs, generator=_gen())
        eager = profiling.records()[-1]
        with profiling.span("restore_cold", faces=B):
            with profiling.cuts(events.append):
                engine._cold_forward(lambda: {"conds": refs, "images": images, "noise": None},
                                     _gen())
            profiling.note(graph="capture")
    rec = profiling.records()[-1]
    assert rec["stages"] == {} and rec["nested"] == {} and rec["graph"] == "capture"
    depth, stages, counts = 0, [], {}
    for e in events:
        if e[0] == "enter":
            if depth == 0:
                stages.append(e[1])
            elif e[2] is not None:
                counts[e[1]] = counts.get(e[1], 0) + e[2]
            depth += 1
        else:
            assert e == ("exit",)
            depth -= 1
    assert depth == 0
    assert stages == list(eager["stages"]) and counts == eager["counts"]


def test_a_replay_opens_the_captured_spans_between_its_pieces(engine):
    images, _ = _photos()
    static = _StaticCall(engine, ServingEngine._warm_forward, {"ids": IDS, "images": images}, [])
    order = []

    class Piece:
        def __init__(self, i):
            self.i = i

        def replay(self):
            order.append(self.i)

    static.graphs = [Piece(i) for i in range(4)]
    static.events = [("graph", 0), ("enter", "inputs", None), ("graph", 1), ("load",),
                     ("graph", 2), ("exit",), ("enter", "unet", None),
                     ("enter", "transformer", 3), ("graph", 3), ("exit",), ("exit",)]
    static.output = torch.arange(6.0)
    with profiling.tracing():
        with profiling.span("restore", faces=B):
            out = static._replay(lambda: order.append("fill"))
    rec = profiling.records()[-1]
    assert order == [0, 1, "fill", 2, 3]
    assert list(rec["stages"]) == ["inputs", "unet"] and list(rec["nested"]) == ["transformer"]
    assert rec["counts"] == {"transformer": 3}
    assert torch.equal(out, static.output) and out.data_ptr() != static.output.data_ptr()
