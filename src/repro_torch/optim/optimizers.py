"""Optimizers as (init, update) pairs over ``{name: tensor}`` parameter
dicts, as ``repro.optim.optimizers`` over pytrees.

AdamW keeps float32 first and second moments and applies
``(m / b1c) / (sqrt(v / b2c) + eps)``; ``clip_by_global_norm`` divides by
``max(norm, 1e-9)`` (``clip_grad_norm_`` would add 1e-6 instead).  Where
the reference is pure, the port updates in place to save a copy of the
model: ``clip_by_global_norm`` scales the gradients in place,
``update_fn`` advances the moments in ``state`` in place and returns the
updates, and ``apply_updates`` adds them into the parameters in place.
A bfloat16 parameter takes its update rounded to bfloat16, as the
reference's ``astype(p.dtype)`` gives it.  The step counter
stays a host integer, so no update reads the card back.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: int
    mu: Optional[Params]
    nu: Optional[Params]


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    summed in order."""
    total = 0
    for x in tree.values():
        total = total + torch.square(x.float()).sum()
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Params, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-9))``, in
    place; returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, norm


def _lr_fn(learning_rate):
    return (learning_rate if callable(learning_rate)
            else (lambda _: float(np.float32(learning_rate))))


def _bias_correction(b: float, step: int) -> float:
    # 1 - b ** step in float32: the power correctly rounded (from float64)
    # as XLA's float32 power is, then the difference in float32
    power = np.float32(np.float64(np.float32(b)) ** step)
    return float(np.float32(1.0) - power)


def adamw(learning_rate: Callable[[int], float] | float,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          wd_mask: Optional[Callable[[Params], Dict[str, bool]]] = None):
    """Returns (init_fn, update_fn)."""
    lr_fn = _lr_fn(learning_rate)

    def init_fn(params: Params) -> OptState:
        return OptState(step=0,
                        mu={k: torch.zeros_like(p, dtype=torch.float32)
                            for k, p in params.items()},
                        nu={k: torch.zeros_like(p, dtype=torch.float32)
                            for k, p in params.items()})

    @torch.no_grad()
    def update_fn(grads: Params, state: OptState, params: Params):
        step = state.step + 1
        lr = lr_fn(step)
        b1c, b2c = _bias_correction(b1, step), _bias_correction(b2, step)
        mask = wd_mask(params) if wd_mask is not None else {}
        updates = {}
        for k, g in grads.items():
            g32 = g.float()
            m, v, p = state.mu[k], state.nu[k], params[k]
            # the reference's expressions op for op, through one scratch
            # buffer: a fresh tensor per op costs the CPU more than the op
            t = torch.mul(g32, 1 - b1)
            m.mul_(b1).add_(t)
            v.mul_(b2).add_(torch.mul(g32, 1 - b2, out=t).mul_(g32))
            u = torch.div(m, b1c)
            u.div_(torch.div(v, b2c, out=t).sqrt_().add_(eps))
            if weight_decay and mask.get(k, True):
                u.add_(torch.mul(p.float(), weight_decay, out=t))
            updates[k] = u.mul_(-lr).to(p.dtype)
        return updates, OptState(step, state.mu, state.nu)

    return init_fn, update_fn


def sgd(learning_rate: Callable[[int], float] | float,
        momentum: float = 0.0):
    lr_fn = _lr_fn(learning_rate)

    def init_fn(params: Params) -> OptState:
        mu = ({k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()} if momentum else None)
        return OptState(step=0, mu=mu, nu=None)

    def update_fn(grads: Params, state: OptState, params: Params):
        step = state.step + 1
        lr = lr_fn(step)
        if momentum:
            for k, g in grads.items():
                state.mu[k].mul_(momentum).add_(g.float())
            updates = {k: (state.mu[k] * -lr).to(params[k].dtype)
                       for k in grads}
            return updates, OptState(step, state.mu, None)
        updates = {k: (g.float() * -lr).to(params[k].dtype)
                   for k, g in grads.items()}
        return updates, OptState(step, None, None)

    return init_fn, update_fn


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """``p + u``, written into each (float32) parameter in place."""
    for k, u in updates.items():
        params[k].add_(u)
    return params
