"""Console entry points of the port (``pyproject.toml`` ``[project.scripts]``:
``instantrestore-torch-{train,infer,serve,parity,evaluate}``). Each runs
``instantrestore_tpu_torch.cli.<name>.main()`` on the command line's
arguments and returns its exit code; the CLIs are modules of the package,
so an installed package runs them as a source checkout does."""

from __future__ import annotations

import importlib


def _run(name: str) -> int:
    return importlib.import_module(f"instantrestore_tpu_torch.cli.{name}").main()


def train() -> int:
    return _run("train")


def infer() -> int:
    return _run("infer")


def serve() -> int:
    return _run("serve")


def parity() -> int:
    return _run("parity")


def evaluate() -> int:
    return _run("evaluate")
