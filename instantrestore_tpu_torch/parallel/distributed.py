"""Processes and the collectives between them (counterpart of
``instantrestore_tpu/parallel/mesh.py``).

The JAX package trains data-parallel as one SPMD program over a device mesh:
the batch is sharded on its ``data`` axis, params are replicated and XLA
inserts the gradient all-reduce. The port runs one process per card (the
reference trainer's accelerate/DDP layout) and reduces by hand with
``torch.distributed``: NCCL between cards, gloo on the CPU and for two ranks
that share one card (NCCL refuses a card twice). ``make_train_step(...,
process_group=)`` sums the gradients with ``all_reduce_sum_`` before the
optimizer, and each rank's loss is its share of the global batch's loss
(``training/losses/composite.py``), so the sum is JAX's gradient on the
mesh.

Launch: ``torchrun --nproc_per_node=N -m instantrestore_tpu_torch.cli.train
...`` (the ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT`` environment), or ``cli.train --multihost
--coordinator_address host:port --num_processes N --process_id i`` on each
process, as the JAX script takes them. ``make_multislice_mesh`` has no
counterpart: NCCL builds its own rings and trees across nodes, and
``torchrun --nnodes`` is the multi-node launch. Serving on several cards
needs no process group: ``ServingEngine(devices=)``.

``init_distributed`` is never called implicitly; without it every helper
here answers for one process.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

BUCKET_BYTES = 64 << 20  # the all-reduce's flat fp32 buckets
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

_local_device_ids: Optional[List[int]] = None


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    *,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Join the process group: the arguments of JAX's ``init_distributed``,
    each falling back to the ``torchrun`` environment (``MASTER_ADDR:PORT``,
    ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` picks the card, else
    ``local_device_ids``, else the rank modulo the visible cards). A
    ``coordinator_address`` ``host:port`` is a TCP rendezvous; one with a
    scheme (``file:///path``) is passed through. ``backend`` defaults to
    NCCL where CUDA is available and gloo otherwise; a collective that waits
    longer than ``timeout`` raises. A no-op when a group exists."""
    global _local_device_ids
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        raise ValueError("init_distributed needs coordinator_address (host:port) or the "
                         "torchrun environment (MASTER_ADDR, MASTER_PORT)")
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    if local_device_ids is None and "LOCAL_RANK" not in env and torch.cuda.is_available():
        # the coordinator flags name no card: each process of a node takes its own
        local_device_ids = [rank % torch.cuda.device_count()]
    if local_device_ids is not None:
        _local_device_ids = list(local_device_ids)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_device())  # NCCL's communicator binds to the current card
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank,
                            timeout=timeout)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns logging and checkpoints (rank 0)."""
    return process_index() == 0


def local_device() -> torch.device:
    """This process's card: the first of ``init_distributed``'s
    ``local_device_ids`` (given, or the rank modulo the visible cards when
    ``LOCAL_RANK`` is unset), else ``cuda:LOCAL_RANK`` (``cuda:0`` without
    it)."""
    if _local_device_ids:
        return torch.device("cuda", _local_device_ids[0])
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def default_group():
    """The group a multi-process trainer reduces over: the world group once
    ``init_distributed`` ran, else None (one process, no collective)."""
    return dist.group.WORLD if dist.is_initialized() else None


def local_rows(x: Any, global_batch: int, rank: Optional[int] = None,
               count: Optional[int] = None) -> Any:
    """This rank's contiguous rows of ``x`` (a tensor, an array or a
    dict/list/tuple of them) drawn for the whole batch of ``global_batch``:
    the rows ``DataLoader(process_index=, process_count=)`` hands this
    process. A leaf of ``m * global_batch`` rows (per-reference noise)
    gives its ``m`` rows per sample. ``rank`` / ``count`` default to this
    process's; the multi-device engine passes its device's."""
    rank = process_index() if rank is None else rank
    count = process_count() if count is None else count
    if global_batch % count:
        raise ValueError(f"global batch {global_batch} does not divide over {count} ranks")
    per = global_batch // count

    def cut(v):
        if isinstance(v, dict):
            return {k: cut(u) for k, u in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(cut(u) for u in v)
        if v is None or count == 1:
            return v
        if v.shape[0] % global_batch:
            raise ValueError(f"a leaf of {v.shape[0]} rows for a batch of {global_batch}")
        m = v.shape[0] // global_batch
        return v[rank * per * m:(rank + 1) * per * m]

    return cut(x)


def _buckets(tensors: Sequence[torch.Tensor]):
    """Consecutive runs of ``tensors`` of at most ``BUCKET_BYTES`` each (a
    larger tensor alone)."""
    bucket, size = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        if bucket and size + n > BUCKET_BYTES:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += n
    if bucket:
        yield bucket


@torch.no_grad()
def _copy_back(bucket: Sequence[torch.Tensor], flat: torch.Tensor) -> None:
    offset = 0
    for t in bucket:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> int:
    """Sum the fp32 ``tensors`` over the ranks of ``group``, in place,
    through flat buckets of at most ``BUCKET_BYTES``. Returns the bytes
    reduced. A sum, not a mean: gloo has no ``ReduceOp.AVG``, and each
    rank's loss is its share of the global one, so the sum is the global
    gradient."""
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("all_reduce_sum_ takes fp32 tensors")
    total = 0
    for bucket in _buckets(tensors):
        flat = torch.cat([t.detach().reshape(-1) for t in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        _copy_back(bucket, flat)
        total += flat.numel() * 4
    return total


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """Overwrite ``tensors`` with rank ``src``'s, in place, through flat
    buckets of one dtype and device each."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for same in groups.values():
        for bucket in _buckets(same):
            flat = torch.cat([t.detach().reshape(-1) for t in bucket])
            dist.broadcast(flat, src, group=group)
            _copy_back(bucket, flat)


def barrier(group=None) -> None:
    """Wait for every rank of ``group``; a no-op without a process group."""
    if dist.is_initialized():
        dist.barrier(group=group)


_BITS = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


def check_replicas_agree(tensors: Sequence[torch.Tensor], names: Optional[Sequence[str]] = None,
                         group=None) -> None:
    """Raise on every rank when the ranks' ``tensors`` differ in any bit:
    two int64 checksums of each tensor's bits (their sum and the sum of
    their squares, wrapping) go through one MAX all-reduce beside their
    negations, and a tensor agrees where the maximum equals the minimum."""
    if not dist.is_initialized() or not tensors:
        return
    sums = []
    for t in tensors:
        bits = t.detach().contiguous().reshape(-1).view(_BITS[t.element_size()]).long()
        sums.append(torch.stack([bits.sum(), (bits * bits).sum()]))
    v = torch.stack(sums)
    both = torch.cat([v, -v])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    n = len(sums)
    differ = (both[:n] != -both[n:]).any(dim=1).nonzero().flatten().tolist()
    if differ:
        labels = [names[i] if names else str(i) for i in differ[:5]]
        raise RuntimeError(f"the ranks' replicas differ in {len(differ)} of {n} tensors "
                           f"(first: {labels})")
