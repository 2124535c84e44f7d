"""The worker processes behind ``ServingEngine(devices=)``: the calling
process serves the first device, and each further device gets a process of
its own, started with the ``spawn`` context (CUDA does not survive a
fork). A worker makes its card current, copies the caller's serving bundle
onto it (its own replica), builds a one-device ``ServingEngine`` there and
then answers commands: the rows of an onboarding, the identity cache, a row
of it, its rows of a warm or cold restore, and an int8 engine's calibrated
scales (the bundle it receives is already quantized, its scales fp32). So each card's forward is
issued by a host thread of its own process, and no card waits for another's
launches at the interpreter lock.

Tensors cross on ``torch.multiprocessing`` pipes: a CPU tensor through CPU
shared memory (its storage moved into shared memory once, a file descriptor
passed), a CUDA tensor as a CUDA IPC handle, which the receiver copies to its
own device (a peer copy). A warm batch of 512 px rows sends each worker row
786,432 bytes of uint8 image, 131,072 of fp32 noise (two [64, 64, 4] draws)
and 8 of identity id, and returns 1,572,864 bytes of bf16 output: 2,490,376
bytes a worker row, 119.5 MB for a batch of 64 over four cards (48 rows
leave the calling process). A cold batch adds each row's four references
(3,145,728 bytes of uint8 and 524,288 of noise).

Each command carries the caller's ``INSTANTRESTORE_*`` environment (the
algorithm switches are read at every call), and each reply the kernel
launches the worker made, which the caller adds to its own wrappers'
counts (``ops/flash_vjp.add_launch_counts``). An exception in a worker is
raised again in the caller, its cause the worker's traceback. A worker that
has died makes every later call raise; nothing is retried. ``close()`` (or
the engine's ``with`` block, or the interpreter's exit) stops every worker.
"""

from __future__ import annotations

import os
import pickle
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

ENV_PREFIX = "INSTANTRESTORE_"
JOIN_S = 30.0  # a worker that does not stop this long after ``close`` is killed


class RemoteTraceback(Exception):
    """The traceback of a worker's exception, as the cause of its re-raise."""

    def __str__(self):
        return self.args[0]


def own_copy(tree: Any, device: torch.device) -> Any:
    """A tree (dicts, lists, tuples, dataclasses of tensors) copied onto
    ``device`` into memory of this process, never a view of a received
    tensor."""
    import dataclasses

    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: own_copy(getattr(tree, f.name), device)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: own_copy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(own_copy(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    return tree


def _sync_env(env: Dict[str, str]) -> None:
    """This process's ``INSTANTRESTORE_*`` variables made ``env``'s."""
    for k in [k for k in os.environ if k.startswith(ENV_PREFIX) and k not in env]:
        del os.environ[k]
    os.environ.update(env)


def _serve(conn, device: str, statics, engine_kw: dict, threads: int) -> None:
    """A worker's body: build the engine on ``device`` from the bundle the
    first message brings, then answer commands until ``close`` or the pipe
    ends."""
    from instantrestore_tpu_torch.inference.serving import ServingEngine
    from instantrestore_tpu_torch.ops import flash_vjp as fv

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # the card current before anything is built on it
    else:
        torch.set_num_threads(threads)
    engine = None

    def reply(fn):
        before = fv.launch_counts()
        try:
            value = fn()
        except Exception as e:  # the boundary: the caller re-raises it
            try:
                pickle.loads(pickle.dumps(e))
            except Exception:  # an exception that does not make the trip
                e = RuntimeError(repr(e))
            conn.send(("error", e, traceback.format_exc(), {}))
            return
        after = fv.launch_counts()
        conn.send(("ok", value, None, {k: after[k] - before[k] for k in after if after[k] != before[k]}))

    def build(params):
        nonlocal engine
        engine = ServingEngine(own_copy(params, dev), statics, device=dev, **engine_kw)

    commands: Dict[str, Callable[..., Any]] = {
        "onboard_rows": lambda refs, noise: engine._onboard_rows(refs, noise, None),
        "set_cache": lambda cache: engine._set_cache(own_copy(cache, dev)),
        "write_row": lambda slot, row: engine._write_row(slot, row),
        "restore": lambda images, ids, noise: engine.restore(images, ids, noise=noise),
        "restore_cold": lambda images, conds, noise: engine.restore_cold(images, conds,
                                                                         noise=noise),
        "cache": lambda: engine.kv_cache,
        "calibrate": lambda slots, scales, margin: engine._calibrate(slots, scales, margin),
    }

    def handle(msg) -> bool:
        cmd, args, env = msg
        if cmd == "close":
            return False
        _sync_env(env)
        with torch.no_grad():
            reply(lambda: build(*args) if cmd == "init" else commands[cmd](*args))
        return True

    while True:  # the received tensors die with each message
        try:
            if not handle(conn.recv()):
                return
        except EOFError:
            return


class _Failure:
    """A worker's exception (or its death), raised once every reply is in."""

    def __init__(self, exc: BaseException, tb: Optional[str] = None):
        self.exc, self.tb = exc, tb

    def raise_(self):
        if self.tb is None:
            raise self.exc
        raise self.exc from RemoteTraceback(f"\n\nthe worker's traceback:\n{self.tb}")


class Worker:
    """One device's process and the caller's end of its pipe."""

    def __init__(self, ctx, device: torch.device, statics, engine_kw: dict):
        self.device = device
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_serve, daemon=True, name=f"serving-worker-{device}",
                                args=(child, str(device), statics, engine_kw,
                                      torch.get_num_threads()))
        self.proc.start()
        child.close()

    def _dead(self) -> RuntimeError:
        return RuntimeError(f"the serving worker for {self.device} is dead (exit code "
                            f"{self.proc.exitcode}); make a new engine")

    def send(self, cmd: str, args: Sequence[Any]) -> None:
        if not self.proc.is_alive():
            raise self._dead()
        env = {k: v for k, v in os.environ.items() if k.startswith(ENV_PREFIX)}
        self.conn.send((cmd, tuple(args), env))

    def reply(self):
        """The value of the command sent last, or a ``_Failure``; the
        worker's launches are added to this process's counts."""
        from instantrestore_tpu_torch.ops import flash_vjp as fv

        while not self.conn.poll(1.0):
            if not self.proc.is_alive():
                return _Failure(self._dead())
        try:
            status, value, tb, counts = self.conn.recv()
        except EOFError:
            return _Failure(self._dead())
        fv.add_launch_counts(counts)
        return _Failure(value, tb) if status == "error" else value

    def stop(self) -> None:
        try:
            if self.proc.is_alive():
                self.conn.send(("close", (), {}))
        except OSError:  # the pipe of a worker that died
            pass
        self.proc.join(JOIN_S)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(JOIN_S)
        self.conn.close()


def _stop_all(workers: List[Worker]) -> None:
    for w in workers:
        w.stop()


class WorkerPool:
    """The processes of ``devices``, each holding its own replica of
    ``params`` in an engine of ``engine_kw``; stopped by ``close`` or when
    the pool is collected or the interpreter exits."""

    def __init__(self, devices: Sequence[torch.device], params: Any, statics, engine_kw: dict):
        ctx = mp.get_context("spawn")
        self.workers: List[Worker] = []
        self._finalizer = weakref.finalize(self, _stop_all, self.workers)
        for d in devices:
            self.workers.append(Worker(ctx, d, statics, engine_kw))
        self.run("init", [(params,)] * len(self.workers))

    def run(self, cmd: str, args: Sequence[Sequence[Any]],
            own: Optional[Callable[[], Any]] = None) -> List[Any]:
        """Send ``cmd(*args[i])`` to worker i, run ``own()`` here meanwhile,
        and return [own's value, worker 0's, ...]. Once every reply is in,
        raises the caller's exception, else the first worker's."""
        sent, error, mine = [], None, None
        try:
            for w, a in zip(self.workers, args):
                w.send(cmd, a)
                sent.append(w)
            if own is not None:
                mine = own()
        except BaseException as e:  # raised below, after the replies are drained
            error = e
        replies = [w.reply() for w in sent]
        if error is not None:
            raise error
        for r in replies:
            if isinstance(r, _Failure):
                r.raise_()
        return [mine] + replies

    def close(self) -> None:
        self._finalizer()
