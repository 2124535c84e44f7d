"""The generator's optimizer and learning-rate schedules (counterpart of
``instantrestore_tpu/training/optim.py``): AdamW over the trainable leaves
only, after a clip by the global norm of those leaves' gradients, under the
diffusers-style schedules the reference uses.

The update is optax's, written out: the clip scales every gradient by
``max_norm / max(norm, max_norm)`` (not ``clip_grad_norm_``'s ``max_norm /
(norm + 1e-6)``); AdamW has decoupled weight decay and ``eps`` outside the
root. The schedules are evaluated at the step count before the update, from
0, so every schedule with a warm-up gives a learning rate of 0 on the first
step. Moments are fp32 and exist for the trainable leaves only; frozen leaves
are never touched.

Gradient accumulation over k micro-steps is ``optax.MultiSteps``'s: each
call folds its gradients into a running mean (``acc + (g - acc) / (n + 1)``),
and every k-th call clips that mean and takes the AdamW step with it; the
step count, and with it the schedule, advances per applied step. Across
processes the caller passes each micro-step's gradient already summed over
the ranks (``make_train_step(process_group=)``, the Coach's D step), so the
running mean and the clip are the global ones, as on JAX's mesh, and every
rank's moments stay equal.

The schedule's learning rate, the bias corrections and the running mean's
divisor are device scalars that the host writes before each micro-step
(``write_scalars``), so the device part of an update (``update(...,
phase=)``) reads no host value and can be captured in a CUDA graph; the
counts advance on the host after it (``advance``). ``update`` without
``phase`` does all three.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import torch

from instantrestore_tpu_torch.configs.config import OptimConfig, SchedulerType


def make_lr_schedule(cfg: OptimConfig, max_steps: int) -> Callable[[int], float]:
    """step -> learning rate, for the scheduler types the reference uses. A
    warm-up is linear from 0 to the base rate over ``lr_warmup_steps``; the
    schedule after it is evaluated at ``step - warmup`` and, as in the JAX
    package, subtracts the warm-up once more inside its own formula."""
    warmup, base, st = cfg.lr_warmup_steps, cfg.learning_rate, cfg.scheduler_type
    span = max(max_steps - warmup, 1)

    def progress(step):  # of a step counted from the end of the warm-up
        return min(max((step - warmup) / span, 0.0), 1.0)

    def linear(step, start, end, steps):
        return start if steps <= 0 else start + (end - start) * min(max(step / steps, 0.0), 1.0)

    if st == SchedulerType.CONSTANT:
        return lambda step: base
    if st == SchedulerType.CONSTANT_WITH_WARMUP:
        after = lambda step: base
    elif st == SchedulerType.LINEAR:
        after = lambda step: linear(step, base, 0.0, span)
    elif st == SchedulerType.COSINE:
        after = lambda step: base * 0.5 * (
            1.0 + math.cos(math.pi * progress(step) * cfg.lr_num_cycles * 2 * 0.5))
    elif st == SchedulerType.COSINE_WITH_RESTARTS:
        after = lambda step: base * 0.5 * (
            1.0 + math.cos(math.pi * ((cfg.lr_num_cycles * progress(step)) % 1.0)))
    elif st == SchedulerType.POLYNOMIAL:
        after = lambda step: base * (1.0 - progress(step)) ** cfg.lr_power
    else:
        raise ValueError(f"unsupported scheduler type {st}")
    return lambda step: linear(step, 0.0, base, warmup) if step < warmup else after(step - warmup)


def trainable_leaves(params: Any, mask: Any) -> List[torch.Tensor]:
    """The leaves of ``params`` whose ``mask`` entry is True, in tree order."""
    if isinstance(mask, dict):
        return [t for k in mask for t in trainable_leaves(params[k], mask[k])]
    if isinstance(mask, (list, tuple)):
        return [t for p, m in zip(params, mask) for t in trainable_leaves(p, m)]
    return [params] if mask else []


def freeze_non_trainable(params: Any, mask: Any) -> Any:
    """``requires_grad_`` on every leaf of ``params`` by its ``mask`` entry,
    so that the backward pass skips the frozen ones; returns ``params``."""
    if isinstance(mask, dict):
        for k in mask:
            freeze_non_trainable(params[k], mask[k])
    elif isinstance(mask, (list, tuple)):
        for p, m in zip(params, mask):
            freeze_non_trainable(p, m)
    else:
        params.requires_grad_(bool(mask))
    return params


class MaskedAdamW:
    """AdamW with global-norm clipping over the trainable leaves of one
    param tree, optionally over the mean of ``accumulation_steps``
    micro-steps' gradients. ``bind`` (or the first ``update``) binds it to
    the leaves and makes their moments; ``count`` is the number of steps
    applied, ``mini_step`` the micro-steps accumulated since the last one."""

    def __init__(self, cfg: OptimConfig, max_steps: int, trainable_mask: Any,
                 accumulation_steps: int = 1):
        if accumulation_steps < 1:
            raise ValueError(f"accumulation_steps must be >= 1, got {accumulation_steps}")
        self.cfg, self.mask = cfg, trainable_mask
        self.accumulation_steps = accumulation_steps
        self.schedule = make_lr_schedule(cfg, max_steps)
        self.count = 0
        self.mini_step = 0
        self.leaves: Optional[List[torch.Tensor]] = None
        self.exp_avg: List[torch.Tensor] = []
        self.exp_avg_sq: List[torch.Tensor] = []
        self.acc_grads: List[torch.Tensor] = []
        self.last_grad_norm: Optional[torch.Tensor] = None
        # device scalars of the next micro-step: the learning rate, 1 - b1^t,
        # 1 - b2^t (t the count after the step) and the running mean's divisor
        self.scalars: Dict[str, torch.Tensor] = {}

    def bind(self, params: Any) -> List[torch.Tensor]:
        """Bind to the trainable leaves of ``params`` (the first call makes
        the moments and the device scalars; later ones check that the leaves
        are the same tensors) and return them."""
        leaves = trainable_leaves(params, self.mask)
        if self.leaves is None:
            if any(t.dtype != torch.float32 for t in leaves):
                raise TypeError("trainable leaves must be fp32 (the compute dtype is cast inside "
                                "the ops)")
            self.leaves = leaves
            self.exp_avg = [torch.zeros_like(t) for t in leaves]
            self.exp_avg_sq = [torch.zeros_like(t) for t in leaves]
            if self.accumulation_steps > 1:
                self.acc_grads = [torch.zeros_like(t) for t in leaves]
            dev = leaves[0].device if leaves else torch.device("cpu")
            self.scalars = {k: torch.zeros((), device=dev) for k in ("lr", "bc1", "bc2", "div")}
        elif len(leaves) != len(self.leaves) or any(a is not b for a, b in
                                                    zip(leaves, self.leaves)):
            raise ValueError("the optimizer is bound to another param tree")
        return leaves

    def state(self) -> Dict[str, Any]:
        """The optimizer's state as tensors, lists and ints (a checkpoint's)."""
        return {"count": self.count, "mini_step": self.mini_step,
                "exp_avg": list(self.exp_avg), "exp_avg_sq": list(self.exp_avg_sq),
                "acc_grads": list(self.acc_grads)}

    @torch.no_grad()
    def load_state(self, params: Any, state: Dict[str, Any]) -> None:
        """Bind to the trainable leaves of ``params`` and copy ``state`` (from
        ``state()``) into the moments and the accumulation buffers."""
        self.bind(params)
        for name in ("exp_avg", "exp_avg_sq", "acc_grads"):
            mine, theirs = getattr(self, name), state[name]
            if len(mine) != len(theirs):
                raise ValueError(f"{name}: {len(theirs)} tensors for {len(mine)} leaves")
            for a, b in zip(mine, theirs):
                a.copy_(b)
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])

    def applies(self) -> bool:
        """Whether the next micro-step takes the AdamW step (the last of its
        accumulation cycle)."""
        return self.mini_step == self.accumulation_steps - 1

    @torch.no_grad()
    def write_scalars(self) -> bool:
        """Write the next micro-step's device scalars from the host counts
        (kernel launches, no copy from host memory); returns ``applies()``."""
        t, b1, b2 = self.count + 1, self.cfg.adam_beta1, self.cfg.adam_beta2
        values = {"lr": self.schedule(self.count), "bc1": 1.0 - b1 ** t, "bc2": 1.0 - b2 ** t,
                  "div": float(self.mini_step + 1)}
        for k, v in values.items():
            self.scalars[k].fill_(v)
        return self.applies()

    def advance(self) -> None:
        """Count the micro-step just taken."""
        if self.applies():
            self.count += 1
            self.mini_step = 0
        else:
            self.mini_step += 1

    @torch.no_grad()
    def update(self, params: Any, grads: List[torch.Tensor], *,
               phase: Optional[bool] = None) -> None:
        """One micro-step on the trainable leaves of ``params``, in place,
        from their gradients ``grads`` (tree order, fp32), which are left as
        given. Without accumulation every call is a step. ``last_grad_norm``
        is the global norm of ``grads``.

        ``phase`` (a step captured in a CUDA graph): ``applies()`` of this
        micro-step, fixed by the caller, who calls ``write_scalars`` before
        the step runs and ``advance`` after it; the call itself then launches
        device work only."""
        leaves = self.bind(params)
        if len(grads) != len(leaves):
            raise ValueError(f"{len(grads)} gradients for {len(leaves)} trainable leaves")
        eager = phase is None
        if eager:
            phase = self.write_scalars()
        self.last_grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.accumulation_steps == 1:
            self._apply(leaves, grads, self.last_grad_norm)
        else:
            # the running mean of the micro-steps' gradients, as optax.MultiSteps
            diff = torch._foreach_sub(grads, self.acc_grads)
            torch._foreach_div_(diff, self.scalars["div"])
            torch._foreach_add_(self.acc_grads, diff)
            if phase:
                mean = self.acc_grads
                self._apply(leaves, mean,
                            torch.linalg.vector_norm(torch.stack(torch._foreach_norm(mean))))
                torch._foreach_zero_(self.acc_grads)
        if eager:
            self.advance()

    def _apply(self, leaves: List[torch.Tensor], grads: List[torch.Tensor],
               norm: torch.Tensor) -> None:
        cfg, sc = self.cfg, self.scalars
        if cfg.use_clip_grad:
            max_norm = cfg.clip_grad_max_norm
            grads = torch._foreach_mul(grads, max_norm / norm.clamp_min(max_norm))
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        torch._foreach_lerp_(self.exp_avg, grads, 1.0 - b1)
        torch._foreach_mul_(self.exp_avg_sq, b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, 1.0 - b2)
        denom = torch._foreach_div(self.exp_avg_sq, sc["bc2"])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.adam_epsilon)
        step = torch._foreach_div(self.exp_avg, denom)
        torch._foreach_div_(step, sc["bc1"])
        torch._foreach_add_(step, leaves, alpha=cfg.adam_weight_decay)
        torch._foreach_mul_(step, sc["lr"])
        torch._foreach_sub_(leaves, step)


def make_optimizer(cfg: OptimConfig, max_steps: int, trainable_mask: Any,
                   accumulation_steps: int = 1) -> MaskedAdamW:
    """AdamW over the masked (trainable) leaves with gradient clipping; frozen
    leaves get no update and hold no optimizer state. With
    ``accumulation_steps`` k > 1 the step is taken every k-th call, on the
    mean of the k calls' gradients."""
    return MaskedAdamW(cfg, max_steps, trainable_mask, accumulation_steps)
