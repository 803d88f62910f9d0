"""Loss and train step (port of ``repro/training/train_step.py``).

The gradient is autograd's over the model's train-mode forward
(``Model.forward``: every block under a checkpoint, the flash kernel's
and the norms' gradients in torch ops), where the reference takes
``jax.value_and_grad``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.specs import is_dtensor, local_call
from repro_torch.training.optimizer import adamw_update, cosine_lr
from repro_torch.training.tree import leaves, tree_map, unflatten


def _chunk_nll(xx, head_w, tt, mm):
    """(sum of masked nll, sum of mask) of one chunk: logits in the
    model dtype over the padded vocab, cast to f32, as the reference's
    ``einsum(...).astype(f32)``."""
    lg = (xx @ head_w.T).to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    gold = _gold(lg, tt.long())
    return torch.sum((logz - gold) * mm), torch.sum(mm)


def _gold(lg, tt):
    """The logits of the targets ``tt`` (B, C) in ``lg`` (B, C, V); a
    DTensor's vocab shards each read the targets they hold (the rest
    zero) and the shards' values sum (a ``Partial``), as GSPMD gathers
    from a vocab-sharded table."""
    if not is_dtensor(lg):
        return torch.gather(lg, -1, tt[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = lg.device_mesh
    vocab = [i for i, p in enumerate(lg.placements)
             if isinstance(p, Shard) and p.dim == 2]
    lp = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in lg.placements]
    tp = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in lp]
    outp = [Partial() if i in vocab else p for i, p in enumerate(tp)]

    def run(lg, tt):
        v = lg.shape[-1]
        off = 0
        for i in vocab:        # the shard's first row, axes in mesh order
            off = off * mesh.size(i) + mesh.get_local_rank(i)
        idx = tt - off * v
        mine = (idx >= 0) & (idx < v)
        g = torch.gather(lg, -1, idx.clamp(0, v - 1)[..., None])[..., 0]
        return torch.where(mine, g, torch.zeros_like(g))
    return local_call(run, (lg, tt), (lp, tp), outp)


def chunked_ce(x, head_w, targets, mask, chunk: int = 512):
    """Cross-entropy without materializing (B, S, V) float32 logits: the
    sequence in chunks (the reference's rule: the largest chunk <= 512
    that divides S), each under a checkpoint, so the backward pass
    recomputes a chunk's logits instead of storing them."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        nll, m = checkpoint(_chunk_nll, x[:, c0:c0 + chunk], head_w,
                            targets[:, c0:c0 + chunk], mask[:, c0:c0 + chunk],
                            use_reentrant=False, preserve_rng_state=False)
        tot = tot + nll
        cnt = cnt + m
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(model, params, batch):
    """Next-token cross entropy (+ MoE aux), chunked over the sequence."""
    hidden, _, aux = model.forward(params, batch, mode="train",
                                   return_hidden=True)
    tokens = batch["tokens"]
    # predict t+1 from t; last position masked out
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=torch.float32),
                      torch.zeros_like(tokens[:, :1], dtype=torch.float32)],
                     dim=1)
    if batch.get("loss_mask") is not None:
        mask = mask * batch["loss_mask"].to(torch.float32)
    ce = chunked_ce(hidden, model.head_weight(params), targets, mask)
    total = ce + aux["moe_aux_loss"]
    return total, {"ce": ce, **aux}


def value_and_grad(model, params, batch):
    """(loss, metrics, grads) of :func:`loss_fn` at ``params``, the
    gradients a tree of the parameters' structure and dtypes; the
    parameters themselves are left as they are (the gradient is taken
    through detached copies of them)."""
    gparams = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(model, gparams, batch)
        grads = torch.autograd.grad(loss, leaves(gparams))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, grads))


def make_train_step(model, *, base_lr=3e-4, warmup=100, total_steps=10_000,
                    weight_decay=0.1):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics)."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(model, params, batch)
        lr = cosine_lr(opt_state.step, base_lr, warmup, total_steps)
        params, opt_state, gnorm = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=weight_decay)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return train_step
