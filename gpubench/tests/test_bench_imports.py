"""What the benchmark loads: never JAX or the JAX package, and the plain
reference nothing of the program."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
HARNESS = ["gpubench.run", "gpubench.traffic", "gpubench.weights", "gpubench.flops",
           "gpubench.trace", "gpubench.drivers.serve"]
REFERENCE = ["gpubench.reference.model", "gpubench.reference.layout"]


def _loaded(modules):
    """Top-level names of every module a fresh interpreter holds after
    importing ``modules`` and loading every metric reader."""
    code = (
        "import importlib, importlib.util, pathlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "for p in sorted(pathlib.Path('gpubench/metrics').glob('*.py')):\n"
        "    s = importlib.util.spec_from_file_location('metric_' + p.stem.replace('.', '_'), p)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(out.stdout.split())


@pytest.mark.parametrize("modules, banned", [
    (HARNESS + REFERENCE, {"jax", "jaxlib", "flax", "instantrestore_tpu"}),
    (REFERENCE, {"jax", "jaxlib", "flax", "instantrestore_tpu", "instantrestore_tpu_torch"}),
])
def test_nothing_banned_is_loaded(modules, banned):
    loaded = _loaded(modules)
    assert "gpubench" in loaded
    assert not loaded & banned, loaded & banned


def test_run_refuses_without_a_card(capsys):
    """No CUDA card: a non-zero exit and nothing on standard output."""
    import torch

    from gpubench import run

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "serve-warm-b16-online", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    from gpubench import run

    monkeypatch.setitem(sys.modules, "instantrestore_tpu_torch_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert run.forbidden_modules() == ["jaxlib"]
