"""A whole serving run on the CPU at a tiny size (the look for a card
skipped), sound and with the timed path broken underneath: a sound run is
``correct``, and each fault a serving cell can have makes it not correct,
with the cell's own limit."""

import json
import time
from pathlib import Path

import pytest
import torch

from gpubench.drivers import serve
from gpubench.tests.tiny import tiny_config
from gpubench.traffic import load_mix
from instantrestore_tpu_torch.inference.serving import ServingEngine

LIMITS = Path(__file__).resolve().parent.parent / "limits"
WORKLOADS = ["serve-warm-b16-online", "serve-cold-b8-online"]


def _run(workload: str) -> dict:
    cfg = tiny_config()
    cfg["model"]["dtype"] = "float32"  # the plain kernels in fp32: sound runs read ~1e-6
    mix = dict(load_mix(workload), batch=4, pool_batches=2, sample_batches=2, reference_block=2)
    if "identities" in mix:
        mix["identities"] = 6
    limits = json.loads((LIMITS / f"{workload}.json").read_text())["limits"]
    ctx = serve.RunContext(config=cfg, mix=mix, seed=2**31 + 11, seconds=2.0, trace=False,
                           device=torch.device("cpu"), chips=1, t_start=time.perf_counter(),
                           limits=limits)
    return serve.run(ctx)


def _half_batch(fn):
    """Restores only the first half of the batch; the rest repeat it."""
    def broken(self, images, other, *, noise):
        h = images.shape[0] // 2
        part = {k: v[:h * (v.shape[0] // images.shape[0])] for k, v in noise.items()}
        out = fn(self, images[:h], other[:h], noise=part)
        return torch.cat([out, out])
    return broken


def _one_face_altered(fn):
    """One face of each batch shifted where it is produced."""
    def broken(self, images, other, *, noise):
        out = fn(self, images, other, noise=noise).clone()
        out[0] += 0.25
        return out
    return broken


def _other_references(fn):
    """Each face restored with the previous face's references: warm, the
    identity ids rolled by one; cold, the reference photos rolled by one."""
    def broken(self, images, other, *, noise):
        return fn(self, images, other.roll(1, 0), noise=noise)
    return broken


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"], result["checks"]
    kept = min(result["batches"], 2)  # sample_batches
    for check in result["checks"].values():
        assert check["faces"] == kept * result["attempted"] // result["batches"]


@pytest.mark.parametrize("fault", [_half_batch, _one_face_altered])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_restore_is_not_correct(workload, fault, monkeypatch):
    name = "restore" if workload.startswith("serve-warm") else "restore_cold"
    monkeypatch.setattr(ServingEngine, name, fault(getattr(ServingEngine, name)))
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_other_references_fail_the_refs_effect(workload, monkeypatch):
    """A face served with another face's references is not correct, and
    the references' own effect is the number that catches it."""
    name = "restore" if workload.startswith("serve-warm") else "restore_cold"
    monkeypatch.setattr(ServingEngine, name, _other_references(getattr(ServingEngine, name)))
    result = _run(workload)
    check = result["checks"]["worst_face_refs_effect_err"]
    assert not result["correct"]
    assert check["value"] > check["limit"], check
