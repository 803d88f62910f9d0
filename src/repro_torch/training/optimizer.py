"""AdamW and the cosine schedule (port of ``repro/training/optimizer.py``).

The same arithmetic in the same order: a global-norm clip over every
gradient leaf (summed in the reference's leaf order), bias corrections,
the weight decay added inside the update, and the new parameter cast
back to its dtype; moments in f32 whatever the parameter dtype.  Not
``torch.optim.AdamW``, which orders and rounds the update otherwise.
Functional, as the reference is: each call returns new tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.training.tree import leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32
    mu: dict
    nu: dict


def adamw_init(params) -> AdamWState:
    device = leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params))


def cosine_lr(step, base_lr: float, warmup: int, total: int,
              min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup over ``warmup`` steps, then a cosine from
    ``base_lr`` down to ``min_frac * base_lr`` at ``total``; f32."""
    step = torch.as_tensor(step)
    warm = (step + 1).to(torch.float32) * base_lr / max(1, warmup)
    prog = torch.clamp((step - warmup).to(torch.float32)
                       / max(1, total - warmup), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """(new params, new state, global gradient norm before the clip)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in leaves(grads)))
    scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
    step = state.step + 1
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        update = update + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * update).to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves(params), leaves(grads), leaves(state.mu), leaves(state.nu))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v), gnorm
