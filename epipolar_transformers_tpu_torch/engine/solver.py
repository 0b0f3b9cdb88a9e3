"""Optimizer and learning-rate schedule (PyTorch), with optax's updates.

Port of epipolar_transformers_tpu/engine/solver.py (reference
engine/solver.py:5-22): sgd with momentum, adam or rmsprop, decoupled L2
(`optax.add_decayed_weights`) added to the gradient before the optimizer,
a MultiStepLR schedule, and SOLVER.BATCH_MUL gradient accumulation
(`optax.MultiSteps`).

sgd and adam are torch.optim.SGD and torch.optim.Adam, multi-tensor: their
`weight_decay` adds wd * p to the gradient first, adam bias-corrects both
moments, and undampened momentum is optax's trace, so they compute optax's
updates.  Written here, where torch differs from optax:
  * rmsprop: decay 0.9 and `g / sqrt(nu + eps)` (eps inside the root);
    torch's RMSprop uses alpha 0.99 and `g / (sqrt(v) + eps)`;
  * the schedule is a function of the count of optimizer updates, as optax
    evaluates it: lr * GAMMA ** (milestones e with count >= e *
    steps_per_epoch).  With one update per step that is MultiStepLR stepped
    per epoch;
  * BATCH_MUL = k applies the running mean of k gradients every k-th step
    and leaves the parameters alone in between.  The schedule counts those
    updates, so under k > 1 each milestone lands k times later in epochs,
    exactly as under optax.MultiSteps.
The update count and the accumulated mean are part of the optimizer's state
dict, as in optax, so a checkpoint of the optimizer carries the schedule.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from epipolar_transformers_tpu.config import Config

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RMSPROP_DECAY, RMSPROP_EPS = 0.9, 1e-8


def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """MultiStepLR as a function of the update count (optax
    `piecewise_constant_schedule`).  Any other SOLVER.SCHEDULER raises, as
    the reference does (solver.py:20-21)."""
    s = cfg.SOLVER
    if s.SCHEDULER != "multistep":
        raise NotImplementedError(f"SOLVER.SCHEDULER={s.SCHEDULER!r}")
    boundaries = sorted({int(e) * steps_per_epoch for e in s.STEPS})

    def schedule(count: int) -> float:
        return s.BASE_LR * s.GAMMA ** sum(count >= b for b in boundaries)

    return schedule


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop after add_decayed_weights: g += wd * p,
    nu = 0.9 nu + 0.1 g^2, p -= lr * g / sqrt(nu + eps)."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("this optimizer takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            nus = [self.state[p].setdefault("nu", torch.zeros_like(p)) for p in params]
            torch._foreach_mul_(nus, RMSPROP_DECAY)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - RMSPROP_DECAY)
            denom = torch._foreach_add(nus, RMSPROP_EPS)
            torch._foreach_sqrt_(denom)
            torch._foreach_addcdiv_(params, grads, denom, value=-group["lr"])
        return None


class Optimizer:
    """SOLVER.OPTIMIZER (`inner`, a torch.optim optimizer) on the schedule,
    with BATCH_MUL accumulation.  Call `step()` once per micro-batch after
    `backward()`."""

    def __init__(self, params: Iterable[torch.nn.Parameter], kind: str,
                 schedule: Callable[[int], float], momentum: float = 0.0,
                 weight_decay: float = 0.0, batch_mul: int = 1):
        if batch_mul < 1:
            raise ValueError(f"SOLVER.BATCH_MUL must be >= 1, got {batch_mul}")
        self.params = list(params)
        lr = schedule(0)
        if kind == "sgd":
            self.inner = torch.optim.SGD(self.params, lr, momentum=momentum,
                                         weight_decay=weight_decay, foreach=True)
        elif kind == "adam":
            self.inner = torch.optim.Adam(self.params, lr, betas=(ADAM_B1, ADAM_B2),
                                          eps=ADAM_EPS, weight_decay=weight_decay, foreach=True)
        elif kind == "rmsprop":
            self.inner = RMSprop(self.params, lr, weight_decay=weight_decay)
        else:
            raise NotImplementedError(f"SOLVER.OPTIMIZER={kind!r}")
        self.schedule, self.batch_mul = schedule, batch_mul
        self.count = 0  # optimizer updates applied so far (the schedule's step)
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params] if batch_mul > 1 else []

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        if self.batch_mul > 1:
            with_grad = [(a, p.grad) for a, p in zip(self.acc, self.params) if p.grad is not None]
            if with_grad:
                acc, grads = map(list, zip(*with_grad))
                delta = torch._foreach_sub(grads, acc)
                torch._foreach_div_(delta, self.mini_step + 1)
                torch._foreach_add_(acc, delta)
            self.mini_step = (self.mini_step + 1) % self.batch_mul
            if self.mini_step:
                return
            for p, a in zip(self.params, self.acc):
                p.grad = a
            self.acc = [torch.zeros_like(p) for p in self.params]
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(self.count)
        self.inner.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count, self.mini_step = state["count"], state["mini_step"]
        self.acc = [a.to(p) for a, p in zip(state["acc"], self.params)]


def make_optimizer(cfg: Config, model: torch.nn.Module, steps_per_epoch: int = 1) -> Optimizer:
    """The optimizer of SOLVER.* over `model`'s parameters."""
    s = cfg.SOLVER
    return Optimizer(model.parameters(), s.OPTIMIZER, make_lr_schedule(cfg, steps_per_epoch),
                     momentum=s.MOMENTUM, weight_decay=s.WEIGHT_DECAY, batch_mul=s.BATCH_MUL)
