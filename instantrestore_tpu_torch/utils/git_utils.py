"""Experiment provenance (counterpart of ``instantrestore_tpu/utils/git_utils.py``;
reference: training/utils/git_utils.py)."""

from __future__ import annotations

import subprocess
from pathlib import Path
from typing import Dict


def _git(*args: str) -> str:
    """``git <args>``'s standard output, stripped; "" where git is missing,
    fails or takes longer than 10 s."""
    try:
        return subprocess.run(["git", *args], capture_output=True, text=True,
                              timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def get_git_info() -> Dict[str, str]:
    """The working directory's commit, branch and whether the tree is dirty."""
    return {
        "commit": _git("rev-parse", "HEAD"),
        "branch": _git("rev-parse", "--abbrev-ref", "HEAD"),
        "dirty": "yes" if _git("status", "--porcelain") else "no",
    }


def dump_git_info(exp_dir) -> None:
    """Write ``get_git_info()`` to ``<exp_dir>/git_info.txt``, one ``key: value`` a line."""
    info = get_git_info()
    Path(exp_dir).mkdir(parents=True, exist_ok=True)
    (Path(exp_dir) / "git_info.txt").write_text(
        "\n".join(f"{k}: {v}" for k, v in info.items()) + "\n")
