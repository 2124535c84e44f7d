"""Builds the hand-written CUDA kernels of ``csrc/`` and loads them.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so it
compiles in seconds with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

into the git-ignored ``instantrestore_tpu_torch/_build/``. The file name
carries a hash of the sources, so an edited kernel rebuilds and a current
one is reused. ``build()`` starts one nvcc per source, all at once;
``load()`` builds on first use. The kernel wrappers (``ops/shared_attention.py``,
``ops/flash_vjp.py``, ``ops/primitives.py``) check their tensors with
``check_cuda`` and call an entry point only through ``launch``. Nothing
here runs at import time. Every pointer and the stream cross ctypes as
``c_void_p``; every C entry point returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_bound", "shared_identity", "shared_flash_bound", "flash_online",
           "shared_online", "shared_online_pair", "flash_fwd_lse", "flash_bwd_dq",
           "flash_bwd_dkv", "group_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ctypes signatures of the C entry points: (argtypes, restype)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "flash_bound": {
        "irt_flash_bound_bf16": ([_P] * 5 + [_I] * 6 + [_F, _P], _I),
    },
    "shared_identity": {
        "irt_shared_identity_bf16": ([_P] * 7 + [_I] * 7 + [_F, _P], _I),
    },
    "shared_flash_bound": {
        "irt_shared_flash_bound_bf16": ([_P] * 9 + [_I] * 8 + [_F, _P], _I),
    },
    "flash_online": {
        "irt_flash_online_bf16": ([_P] * 4 + [_I] * 6 + [_F, _P], _I),
    },
    "shared_online": {
        "irt_shared_online_bf16": ([_P] * 7 + [_I] * 7 + [_F, _P], _I),
    },
    "shared_online_pair": {
        "irt_shared_online_pair_bf16": ([_P] * 7 + [_I] * 7 + [_F, _P], _I),
    },
    "flash_fwd_lse": {
        "irt_flash_fwd_lse_bf16": ([_P] * 5 + [_I] * 6 + [_F, _P], _I),
    },
    "flash_bwd_dq": {
        "irt_flash_bwd_dq_bf16": ([_P] * 8 + [_I] * 8 + [_F, _P], _I),
    },
    "flash_bwd_dkv": {
        "irt_flash_bwd_dkv_bf16": ([_P] * 9 + [_I] * 8 + [_F, _P], _I),
    },
    "group_norm": {
        "irt_group_norm_bf16": ([_P] * 3 + [_I, _P, _I, _P, _I, _P, _P] + [_I] * 6 + [_F, _P], _I),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # a multi-device engine's threads may load at once


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, one nvcc each,
    all in parallel. Returns {name: ptxas report} for what was compiled;
    raises with nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, lib)
    reports, failures = {}, []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
        reports[name] = log
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                path = library_path(name)
                if not path.exists():
                    build([name])
                lib = ctypes.CDLL(str(path))
                for fn, (argtypes, restype) in SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
                _loaded[name] = lib
    return lib


count_lock = threading.Lock()  # callers may launch, and add counts, from several threads


def launch(wrapper, source: str, q: torch.Tensor, *args) -> None:
    """Call ``irt_<source>_bf16`` of ``csrc/<source>.cu`` with ``args`` and
    the current stream of q's device, with q's device the calling thread's
    current one: the C launcher's ``cudaFuncSetAttribute``, tensor-map
    encode and launch all act on the current device, so a tensor on
    ``cuda:1`` from a thread at device 0 would otherwise launch on the wrong
    card. Raises on a CUDA error; counts the launch on ``wrapper``."""
    entry = getattr(load(source), f"irt_{source}_bf16")
    with torch.cuda.device(q.device):
        rc = entry(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{source} kernel launch failed: CUDA error {rc}")
    with count_lock:
        wrapper.launches += 1


def check_cuda(name: str, *typed) -> None:
    """Each (tensor, dtype) pair: on the first tensor's device, contiguous,
    16-byte aligned and of that dtype."""
    dev = typed[0][0].device
    for t, dtype in typed:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data is not 16-byte aligned")
        if t.dtype != dtype:
            raise TypeError(f"{name}: kernel takes {dtype}, got {t.dtype}")
