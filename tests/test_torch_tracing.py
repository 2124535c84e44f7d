"""The port's stage spans (``utils/profiling.py``) on the CPU at tiny widths:
off without a profiler, nested in order under one, the calls' records, the
``tracing()`` block and the bounded ring; and the benchmark's readers of the
spans (``gpubench/metrics/``) on hand-built traces and records.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from instantrestore_tpu_torch.inference.serving import ServingEngine
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.models import unet as tunet
from instantrestore_tpu_torch.models import vae as tvae
from instantrestore_tpu_torch.ops.shared_attention import IdentityRef
from instantrestore_tpu_torch.utils import profiling

GPUBENCH = Path(__file__).resolve().parent.parent / "gpubench"
STATICS = trest.RestorerStatics(
    unet_cfg=tunet.UNetConfig(sample_size=8, block_out_channels=(32, 64, 64, 64),
                              attention_heads=(1, 2, 2, 2), cross_attention_dim=16,
                              norm_num_groups=8),
    vae_cfg=tvae.VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4),
    use_adain=True, train_input=False, compute_dtype=torch.float32)
RES, B, N_REFS = 64, 2, 2
WARM = ["ir/restore", "ir/inputs", "ir/encode", "ir/unet", "ir/decode"]
COLD = ["ir/restore_cold", "ir/inputs", "ir/encode", "ir/capture", "ir/unet", "ir/decode"]


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"_tracing_test_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(metric: str):
    return _load(GPUBENCH / "metrics" / f"{metric}.py").read


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


@pytest.fixture(scope="module")
def engine():
    params = trest.init_restorer_params(torch.Generator().manual_seed(0), STATICS,
                                        lora_rank_unet=4, lora_rank_vae=4)
    eng = ServingEngine(trest.serving_bundle(params, STATICS), STATICS, device="cpu")
    gen = torch.Generator().manual_seed(1)
    eng.onboard(torch.randint(0, 256, (2, N_REFS, RES, RES, 3), dtype=torch.uint8,
                              generator=gen), generator=gen)
    return eng


def _photos(seed: int = 2):
    gen = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (B, RES, RES, 3), dtype=torch.uint8, generator=gen)
    refs = torch.randint(0, 256, (B, N_REFS, RES, RES, 3), dtype=torch.uint8, generator=gen)
    return images, refs, gen


def _warm(engine):
    images, _, gen = _photos()
    return engine.restore(images, torch.tensor([1, 0]), generator=gen)


def _cold(engine):
    images, refs, gen = _photos()
    return engine.restore_cold(images, refs, generator=gen)


def _ranges(run, nested=False):
    """(name, start, end) of the ``ir/`` ranges a CPU profile of ``run()``
    holds, in order of start: the calls and their stages, or with ``nested``
    only the ranges inside a stage (the UNet's ``ir/transformer``)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("ir/")
                   and (e.name == "ir/transformer") == nested), key=lambda r: r[1])


def test_spans_are_off_without_a_profiler(engine, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        opened.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _warm(engine)
    _cold(engine)
    assert profiling.records() == []
    assert [n for n in opened if n.startswith("ir/")] == []


@pytest.mark.parametrize("path, names", [(_warm, WARM), (_cold, COLD)], ids=["warm", "cold"])
def test_restore_stages_nest_in_order_under_the_profiler(engine, path, names):
    ranges = _ranges(lambda: path(engine))
    assert [r[0] for r in ranges] == names
    _, start, end = ranges[0]
    for _, s, e in ranges[1:]:
        assert start <= s <= e <= end
    for (_, _, e0), (_, s1, _) in zip(ranges[1:], ranges[2:]):
        assert e0 <= s1  # the stages one after another, none inside another


@pytest.mark.parametrize("path, names", [(_warm, WARM), (_cold, COLD)], ids=["warm", "cold"])
def test_records_hold_the_faces_and_each_stages_ms(engine, path, names):
    with profiling.tracing():
        path(engine)
    (rec,) = profiling.records()
    assert rec["name"] == names[0][3:] and rec["faces"] == B
    assert list(rec["stages"]) == [n[3:] for n in names[1:]]
    assert all(ms >= 0 for ms in rec["stages"].values())
    assert sum(rec["stages"].values()) <= rec["device_ms"]


# (GroupNorms, resnets, attention norms) of the VAE encoder, the UNet and the
# VAE decoder, at SD-Turbo's block layout (the tiny models' too)
_ENC, _UNET, _DEC = (22, 10, 1), (61, 22, 16), (30, 14, 1)


@pytest.mark.parametrize("path, nets", [(_warm, (_ENC, _UNET, _DEC)),
                                        (_cold, (_ENC, _UNET, _ENC, _UNET, _DEC))],
                         ids=["warm", "cold"])
def test_every_group_norm_of_a_restore_fits_the_kernel(engine, path, nets, monkeypatch):
    """Every GroupNorm of a restore (a cold call's capture runs the encoder
    and the UNet once more) gets a contiguous NHWC input whose channels
    divide by 8 and by the groups, so that on the card each takes the kernel
    and none raises. Each resnet's norm2 takes conv1's bias (the VAE's) or
    it and the time-embedding projection (the UNet's); all but the
    attention norms take SiLU."""
    from instantrestore_tpu_torch.ops import primitives

    seen = []

    def recording(p, x, *, num_groups=32, eps=1e-5, in_bias=(), act=None):
        seen.append((x.is_contiguous() and x.shape[-1] % 8 == 0 and x.shape[-1] % num_groups == 0,
                     len(in_bias), act))
        return primitives.group_norm(p, x, num_groups=num_groups, eps=eps, in_bias=in_bias,
                                     act=act)

    monkeypatch.setattr(tunet, "group_norm", recording)
    monkeypatch.setattr(tvae, "group_norm", recording)
    path(engine)
    assert len(seen) == sum(n for n, _, _ in nets) and all(ok for ok, _, _ in seen)
    vae_resnets = sum(r for n, r, _ in nets if n != _UNET[0])
    unet_resnets = sum(r for n, r, _ in nets if n == _UNET[0])
    terms = [t for _, t, _ in seen]
    assert (terms.count(1), terms.count(2)) == (vae_resnets, unet_resnets)
    assert [a for _, _, a in seen].count(None) == sum(a for _, _, a in nets)


def test_tracing_records_without_a_profiler_and_not_after(engine):
    assert not torch.autograd._profiler_enabled()
    with profiling.tracing():
        _warm(engine)
    assert len(profiling.records()) == 1
    _warm(engine)
    _cold(engine)
    assert len(profiling.records()) == 1


def test_the_ring_keeps_the_newest_calls():
    with profiling.tracing():
        for faces in range(1, profiling.RING + 6):
            with profiling.span("restore", faces=faces):
                with profiling.span("unet"):
                    pass
    recs = profiling.records()
    assert len(recs) == profiling.RING
    assert [r["faces"] for r in recs] == list(range(6, profiling.RING + 6))


def test_a_forward_outside_a_call_gets_ranges_but_no_record(engine):
    images, _, gen = _photos()
    ids = torch.tensor([1, 0])
    ranges = _ranges(lambda: trest.restore_forward(
        engine.params, images.float() / 127.5 - 1.0, statics=STATICS,
        precomputed_ref_kv=[IdentityRef(c, ids) for c in engine.kv_cache], generator=gen,
        use_fused_attention=True))
    assert [r[0] for r in ranges] == ["ir/encode", "ir/unet", "ir/decode"]
    assert profiling.records() == []


def test_a_call_that_raises_leaves_no_record_and_no_open_call():
    with profiling.tracing():
        with pytest.raises(ValueError):
            with profiling.span("restore", faces=2):
                with profiling.span("encode"):
                    raise ValueError("bad batch")
        with profiling.span("restore", faces=3):
            pass
    (rec,) = profiling.records()
    assert rec["faces"] == 3 and rec["stages"] == {}


def test_no_event_is_recorded_while_the_stream_is_captured(monkeypatch):
    def no_event(*args, **kwargs):
        raise AssertionError("a timing event was made during a graph capture")

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    with profiling.tracing():
        with profiling.span("restore", faces=2, device="cuda"):
            with profiling.span("unet"):
                pass
    assert profiling.records() == []


# ---------------------------------------------------------------------------
# the benchmark's readers of the spans
# ---------------------------------------------------------------------------


def _summary(window_us: float):
    """A trace of two restore calls, [0, 100] and [200, 300] us: device work
    [10, 60] (two kernels overlapping), [80, 150] (past the first call's
    end), [210, 290] and [320, 400] (between the calls' ends and the window's);
    syncs at 50 and 250 and 260 inside the calls, one at 150 outside."""
    trace = _load(GPUBENCH / "trace.py")

    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [x("user_annotation", "ir/restore", 0, 100),
              x("user_annotation", "ir/encode", 5, 40),
              x("user_annotation", "ir/restore", 200, 100),
              x("kernel", "a", 10, 30), x("kernel", "b", 30, 30), x("kernel", "c", 80, 70),
              x("kernel", "d", 210, 80), x("gpu_memcpy", "e", 320, 80),
              x("cuda_runtime", "cudaLaunchKernel", 20, 2),
              x("cuda_runtime", "cudaStreamSynchronize", 50, 5),
              x("cuda_runtime", "cudaDeviceSynchronize", 150, 5),
              x("cuda_runtime", "cudaEventSynchronize", 250, 5),
              x("cuda_runtime", "cudaStreamSynchronize", 260, 5)]
    return trace.Summary(events, window_us * 1e-6)


def test_program_idle_counts_only_the_gaps_inside_calls():
    trace = _summary(500.0)
    # idle inside the calls: 100 - (50 + 20) and 100 - 80; the gap [150, 200] is between them
    assert _reader("program_idle.serve")({"trace": trace}) == pytest.approx(100 * 50 / 500)
    device_idle = _reader("device_idle.serve")({"trace": trace})
    assert device_idle == pytest.approx(100 * (500 - 280) / 500)


def test_host_syncs_counts_the_syncs_inside_calls_per_call():
    assert _reader("host_syncs_per_batch.serve")({"trace": _summary(500.0)}) == 1.5


def test_trace_readers_read_nothing_without_spans():
    trace = _load(GPUBENCH / "trace.py").Summary(
        [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 10}], 1e-4)
    for metric in ("program_idle.serve", "host_syncs_per_batch.serve", "unet_ms_per_face.serve"):
        assert _reader(metric)({"trace": trace}) is None


def test_stage_readers_average_the_profiled_calls(monkeypatch):
    def rec(faces, **stages):
        return {"name": "restore", "faces": faces, "device_ms": 99.0, "stages": stages}

    recs = [rec(8, encode=100.0, unet=100.0),  # an older call: outside the profiled tail
            rec(2, encode=10.0, unet=1.0), rec(4, encode=30.0, unet=2.0)]
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    run = {"trace": _summary(500.0)}  # two ir/restore ranges: the last two records
    assert _reader("encode_ms_per_face.serve")(run) == pytest.approx(40.0 / 6)
    assert _reader("unet_ms_per_face.serve")(run) == pytest.approx(3.0 / 6)
    assert _reader("capture_ms_per_face.serve")(run) is None  # a warm call has no capture


@pytest.mark.parametrize("metric", ["graph_replay_share.serve", "graph_replay_share.serve_sdxl"])
def test_replay_share_reads_the_profiled_calls_graph_field(monkeypatch, metric):
    def rec(graph=None):
        r = {"name": "restore", "faces": 2, "device_ms": 9.0, "stages": {}}
        return r if graph is None else dict(r, graph=graph)

    run = {"trace": _summary(500.0)}  # two ir/restore ranges: the last two records
    read = _reader(metric)
    for recs, want in (([rec("eager"), rec("capture"), rec("replay")], 50.0),
                       ([rec("eager"), rec("replay"), rec("replay")], 100.0),
                       ([rec("replay"), rec()], None)):  # a program that notes no graph
        monkeypatch.setattr(profiling, "records", lambda: list(recs))
        assert read(run) == want


def test_norm_reader_sums_the_norm_family_per_face():
    """``norm_ms_per_face.serve``: device ms of the kernels the ``norm``
    family names (``gpubench/kernels/group_norm.json``), per profiled face;
    nothing where none ran, as on a tree without the kernel."""
    import json

    trace = _load(GPUBENCH / "trace.py")
    families = {p.stem: json.loads(p.read_text())
                for p in sorted((GPUBENCH / "kernels").glob("*.json"))}

    def x(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}

    names = ["(anonymous namespace)::irt_group_norm_stats_kernel(__nv_bfloat16 const*, int)",
             "(anonymous namespace)::irt_group_norm_apply_kernel(__nv_bfloat16 const*, int)",
             "void at::native::elementwise_kernel<128, 4>(int)"]
    run = {"trace": trace.Summary([x(names[0], 0, 30), x(names[1], 40, 50), x(names[2], 100, 80),
                                   x(names[0], 200, 20)], 1e-3),
           "profiled_faces": 4, "kernel_families": families}
    assert _reader("norm_ms_per_face.serve")(run) == pytest.approx(1e-3 * 100 / 4)
    run["trace"] = trace.Summary([x(names[2], 0, 80)], 1e-3)
    assert _reader("norm_ms_per_face.serve")(run) is None

