"""Capacity-routed (scatter/gather) mixture-of-experts layer.

Port of ``repro/models/moe.py``'s ``moe_init``, ``_capacity`` and
``moe_apply``: a float32 router, softmax, top-k with the gates
renormalised; each claim (token t, choice j) takes the next free place
of its expert in flat ``t * k + j`` order, and a claim at or past the
expert's capacity is dropped (the token passes through on the residual
stream).  Kept claims are dispatched into an ``(E, C, D)`` buffer, SwiGLU
runs on each expert's rows (``torch.bmm``, as the reference's einsums),
and the outputs are gathered back and summed over k, each weighted by
its gate in the model dtype.

Written for the device: every shape is fixed by ``T`` and the config,
and nothing reads a value on the host.  A claim's place is a cumulative
sum over a one-hot of the claims, a dropped claim goes to a sentinel row
``E * C`` of a buffer one row longer (where the reference drops it with
``mode="drop"`` and fills its gather with ``mode="fill"``), and no
boolean mask indexes anything: ``bincount`` and mask indexing would make
the host wait for the card to size their outputs.  The expert-parallel
variants of the reference (``moe_apply_sharded``,
``moe_apply_capsharded``) need a mesh and are not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init

#: leaves the reference keeps in float32 whatever the model dtype
F32_LEAVES = frozenset({"router"})


def _expert_init(generator, shape, dtype, device) -> torch.Tensor:
    """Stacked expert weights ``(n, E, in, out)``, drawn one expert of one
    layer at a time (a whole stack in float32 would be 4 bytes a
    parameter on the card at once), each times ``E ** -0.5``: the
    reference's ``_dense_init`` takes its fan-in from the leading dim of
    ``(E, in, out)``."""
    out = torch.empty(shape, dtype=dtype, device=device)
    scale = shape[1] ** -0.5
    for i in range(shape[0]):
        for e in range(shape[1]):
            out[i, e] = _dense_init(generator, shape[2:], dtype, device,
                                    scale=scale)
    return out


def moe_init(generator: torch.Generator, cfg, dtype, device, n: int) -> dict:
    """``n`` stacked layers of the reference's MoE leaves: the router
    ``(n, D, E)`` in float32 whatever the model dtype, and ``we_gate``,
    ``we_up`` ``(n, E, D, F)``, ``we_down`` ``(n, E, F, D)``."""
    d, f, e = cfg.d_model, cfg.moe_d_ff_eff, cfg.n_experts
    return {
        "router": _dense_init(generator, (n, d, e), torch.float32, device),
        "we_gate": _expert_init(generator, (n, e, d, f), dtype, device),
        "we_up": _expert_init(generator, (n, e, d, f), dtype, device),
        "we_down": _expert_init(generator, (n, e, f, d), dtype, device),
    }


def _capacity(n_tokens: int, cfg) -> int:
    """Places a layer gives each expert for ``n_tokens`` tokens: their
    fair share of the claims times ``capacity_factor``, plus one, rounded
    up to a multiple of 8 and at least 8."""
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)


def moe_apply(params: dict, x: torch.Tensor,
              cfg) -> Tuple[torch.Tensor, dict]:
    """x: (..., T, D) -> (..., T, D), aux metrics (``moe_aux_loss``, the
    Switch-style load-balance term times ``router_aux_weight``, and
    ``moe_drop_frac``, the share of claims dropped), as float32 scalars
    on x's device.  Capacity ranks the claims of every token of ``x``
    together: rows of one batch share it."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = _capacity(t, cfg)

    logits = xt.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.topk(probs, k, dim=-1)                  # (T, k)
    gate = gate / gate.sum(dim=-1, keepdim=True)

    # --- place of each claim within its expert -------------------------
    flat_e = expert.reshape(-1)                                  # (T*k,)
    claims = (flat_e[:, None] == torch.arange(e, device=x.device)
              ).to(torch.int32)                                  # (T*k, E)
    place = ((torch.cumsum(claims, dim=0) - 1) * claims).sum(dim=-1)
    keep = place < cap
    slot = torch.where(keep, flat_e * cap + place,
                       torch.full_like(place, e * cap))  # dropped: sentinel

    # --- dispatch ----------------------------------------------------------
    x_rep = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = xt.new_zeros((e * cap + 1, d))
    buf.index_copy_(0, slot, x_rep)
    buf = buf[:e * cap].view(e, cap, d)

    # --- experts: (E, C, D) x (E, D, F) ------------------------------------
    g = torch.bmm(buf, params["we_gate"])
    u = torch.bmm(buf, params["we_up"])
    out = torch.bmm(F.silu(g) * u, params["we_down"])            # (E, C, D)

    # --- combine: the sentinel row reads zeros ------------------------------
    out = torch.cat([out.reshape(e * cap, d), out.new_zeros((1, d))])
    gathered = out.index_select(0, slot).reshape(t, k, d)
    y = (gathered * gate[..., None].to(gathered.dtype)).sum(dim=1)

    # --- aux: load-balance loss (Switch-style) and drops -------------------
    me = probs.mean(dim=0)
    ce = (expert[:, 0, None] == torch.arange(e, device=x.device)
          ).float().mean(dim=0)
    aux = {"moe_aux_loss": e * (me * ce).sum() * cfg.router_aux_weight,
           "moe_drop_frac": (~keep).sum().float() / (t * k)}
    return y.reshape(shape).to(x.dtype), aux
