"""PyTorch/CUDA port of InstantRestore for NVIDIA Hopper: the serving paths
and the generator training step.

The package mirrors the file layout of ``instantrestore_tpu`` (the JAX
reference) so each module has an obvious counterpart. It imports PyTorch
only: nothing of JAX and nothing of the JAX package.

Layouts at the public functions follow the JAX package (NHWC images and
latents, ``[B, H, S, d]`` attention heads) so tests can compare like with
like. Parameters are nested dicts/lists of tensors in PyTorch layouts
(``weight`` ``[out, in]`` for linears, OIHW for convolutions) whose dotted
paths are the diffusers state-dict names (see ``convert.py``).

The nine attention kernels (six of the serving paths, ``ops/shared_attention
.py``; the forward with its log-sum-exp and the two backward kernels of
training, ``ops/flash_vjp.py``) are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), compiled with ``nvcc`` on first use and loaded with ``ctypes``
(``ops/_build.py``). On a CPU tensor each kernel wrapper runs its plain
PyTorch version instead.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another, ``cuda:N`` for card N. Raises rather than quietly falling back
    to the CPU or to another card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev}: this machine has {torch.cuda.device_count()} CUDA device(s)"
            )
    return dev


_CONSTANTS: Dict[Tuple[Hashable, torch.device], torch.Tensor] = {}


def device_constant(key: Hashable, device, make: Callable[[], object]) -> torch.Tensor:
    """The constant tensor ``make()`` (an array or a CPU tensor) on
    ``device``, made and copied there once per ``key`` and kept: a step
    captured in a CUDA graph may not copy from the host, so every call after
    the first reads the same device tensor. Callers never write to it."""
    dev = torch.device(device)
    t = _CONSTANTS.get((key, dev))
    if t is None:
        t = _CONSTANTS[(key, dev)] = torch.as_tensor(make()).to(dev)
    return t
