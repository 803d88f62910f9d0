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
the host wait for the card to size their outputs.

The reference's shard_map variants take a mesh
(``torch.distributed.device_mesh.DeviceMesh`` here) and each rank's
local tokens: :func:`moe_apply_sharded` (expert-parallel: the rank runs
its ``E / n_model`` experts) and :func:`moe_apply_capsharded` (every
expert, the rank's window of each expert's capacity), each ending in one
all-reduce SUM of the output over the ``model`` axis.  :func:`moe_apply`
takes one of them under ``REPRO_MOE_SHARDMAP`` with a current mesh
(``sharding.specs.use_mesh_rules``) whose model axis is larger than 1.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init
from repro_torch.sharding.specs import (_batch_axes, axis_names, axis_sizes,
                                        constrain, current_mesh, is_dtensor,
                                        local_call)

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


def _route(router: torch.Tensor, xt: torch.Tensor, cfg) -> tuple:
    """The float32 router over tokens xt (T, D): (probs (T, E), gates
    (T, k) renormalised, experts (T, k), the claims' experts (T*k,) and
    their places within their experts (T*k,), in flat ``t * k + j``
    order)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate, expert = torch.topk(probs, k, dim=-1)                  # (T, k)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    flat_e = expert.reshape(-1)                                  # (T*k,)
    claims = (flat_e[:, None] == torch.arange(e, device=xt.device)
              ).to(torch.int32)                                  # (T*k, E)
    place = ((torch.cumsum(claims, dim=0) - 1) * claims).sum(dim=-1)
    return probs, gate, expert, flat_e, place


def _dispatch(xt: torch.Tensor, slot: torch.Tensor, rows: int,
              k: int) -> torch.Tensor:
    """Each claim's token into its buffer row ``slot`` (rows ``rows``:
    the sentinel, one past the buffer's end, takes the dropped claims and
    is cut off).  Returns (rows, D)."""
    t, d = xt.shape
    x_rep = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = xt.new_zeros((rows + 1, d))
    buf.index_copy_(0, slot, x_rep)
    return buf[:rows]


def _experts(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
             wd: torch.Tensor) -> torch.Tensor:
    """SwiGLU on each expert's rows: (E, C, D) x (E, D, F) -> (E, C, D)."""
    return torch.bmm(F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu), wd)


def _combine(out: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor,
             t: int, k: int, dtype=None) -> torch.Tensor:
    """Each claim's expert output gathered back (the sentinel row reads
    zeros) and summed over k, weighted by its gate in the model dtype;
    the sum in ``dtype`` where given."""
    d = out.shape[-1]
    out = torch.cat([out.reshape(-1, d), out.new_zeros((1, d))])
    gathered = out.index_select(0, slot).reshape(t, k, d)
    return (gathered * gate[..., None].to(gathered.dtype)).sum(dim=1,
                                                               dtype=dtype)


def _aux(probs: torch.Tensor, expert: torch.Tensor, keep: torch.Tensor,
         cfg) -> dict:
    """The Switch-style load-balance term and the share of claims
    dropped."""
    e = cfg.n_experts
    t, k = expert.shape
    me = probs.mean(dim=0)
    ce = (expert[:, 0, None] == torch.arange(e, device=probs.device)
          ).float().mean(dim=0)
    return {"moe_aux_loss": e * (me * ce).sum() * cfg.router_aux_weight,
            "moe_drop_frac": (~keep).sum().float() / (t * k)}


def _sharded_form(cfg, x: torch.Tensor):
    """The reference's selection: with ``REPRO_MOE_SHARDMAP`` set and a
    current mesh whose ``model`` axis is larger than 1, the
    expert-parallel form when E divides that axis, else the
    capacity-sharded one; None otherwise."""
    mesh = current_mesh()
    if (not os.environ.get("REPRO_MOE_SHARDMAP") or mesh is None
            or "model" not in axis_names(mesh) or x.ndim != 3
            or axis_sizes(mesh)["model"] <= 1):
        return None
    if cfg.n_experts % axis_sizes(mesh)["model"] == 0:
        return moe_apply_sharded
    return moe_apply_capsharded


def moe_apply(params: dict, x: torch.Tensor,
              cfg) -> Tuple[torch.Tensor, dict]:
    """x: (..., T, D) -> (..., T, D), aux metrics (``moe_aux_loss``, the
    Switch-style load-balance term times ``router_aux_weight``, and
    ``moe_drop_frac``, the share of claims dropped), as float32 scalars
    on x's device.  Capacity ranks the claims of every token of ``x``
    together: rows of one batch share it.  Under ``REPRO_MOE_SHARDMAP``
    and a mesh, one of the sharded forms (:func:`_sharded_form`)."""
    form = _sharded_form(cfg, x)
    if form is not None and is_dtensor(x):
        return _form_on_dtensors(form, params, x, cfg)
    if form is not None:
        return form(params, x, cfg, current_mesh())
    if is_dtensor(x):
        return _moe_on_dtensors(params, x, cfg)
    y, aux = _moe_tokens(params, x.reshape(-1, x.shape[-1]), cfg)
    return y.reshape(x.shape).to(x.dtype), aux


def _in_window(keep, place, cap: int, window: Tuple[int, int]):
    """(the claims of window ``r`` of ``n`` of every expert's capacity,
    its width ``ceil(cap / n)``, each claim's place in it) for ``window
    = (n, r)``; (1, 0) is the whole capacity and adds no operation."""
    n, r = window
    if n == 1:
        return keep, cap, place
    width = -(-cap // n)
    lo = r * width
    return (keep & (place >= lo) & (place < lo + width), width,
            place - lo)


def _moe_tokens(params: dict, xt: torch.Tensor, cfg, dtype=None,
                window=(1, 0)) -> Tuple[torch.Tensor, dict]:
    """Route the tokens xt (T, D), dispatch the claims in ``window`` of
    every expert's capacity (:func:`_in_window`) into the (E, C, D)
    buffer, run every expert whose weights ``params`` hold (whole, or
    each expert's slice of the hidden dim) and combine: (y (T, D), its
    sum over k in ``dtype`` where given, and the aux terms)."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = _capacity(t, cfg)
    probs, gate, expert, flat_e, place = _route(params["router"], xt, cfg)
    keep = place < cap
    mine, cap, at = _in_window(keep, place, cap, window)
    slot = torch.where(mine, flat_e * cap + at,
                       torch.full_like(place, e * cap))  # dropped: sentinel
    buf = constrain(_dispatch(xt, slot, e * cap, k).view(e, cap, d),
                    "moe_buf")
    out = _experts(buf, params["we_gate"], params["we_up"], params["we_down"])
    y = _combine(constrain(out, "moe_buf"), slot, gate, t, k, dtype)
    return y, _aux(probs, expert, keep, cfg)


def _moe_on_dtensors(params: dict, x, cfg) -> Tuple[torch.Tensor, dict]:
    """:func:`moe_apply` of a DTensor x under a mesh, with the
    reference's capacity over every token of x: each rank gathers the
    tokens (x whole), routes them all, and runs the experts its weights
    hold: its range of experts where they are sharded by expert (the
    ``moe_buf`` rule's expert-parallel layout), else every expert on its
    slice of the hidden dim.  Under ``REPRO_MOE_LAYOUT=ep_dp`` (the rule
    that also shards the capacity over the data axes) each data rank
    takes its window of every expert's capacity, as
    :func:`moe_apply_capsharded` does over ``model``.  Its share of y is
    a partial sum over the axes that split the work, reduced as y is
    laid out like x again."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    i = names.index("model") if "model" in names else None
    wp = params["we_gate"].placements
    sharded = i is not None and isinstance(wp[i], Shard)
    data = ([j for j, n in enumerate(names) if n in _batch_axes(mesh)]
            if os.environ.get("REPRO_MOE_LAYOUT") == "ep_dp" else [])
    yp = [Partial() if (sharded and j == i) or j in data else Replicate()
          for j in range(mesh.ndim)]
    d = x.shape[-1]

    def run(router, wg, wu, wd, xs):
        p = {"router": router, "we_gate": wg, "we_up": wu, "we_down": wd}
        xt = xs.reshape(-1, d)
        n, r = 1, 0                            # my window of capacity
        for j in data:
            n, r = n * mesh.size(j), r * mesh.size(j) + mesh.get_local_rank(j)
        if wg.shape[0] != cfg.n_experts:       # my experts, all tokens
            y, aux = moe_sharded_local(p, xt, cfg, mesh, (n, r))
        else:
            y, aux = _moe_tokens(p, xt, cfg, torch.float32
                                 if sharded or data else None, (n, r))
        return y.reshape(xs.shape), aux["moe_aux_loss"], aux["moe_drop_frac"]
    y, loss, drop = local_call(
        run, (params["router"], params["we_gate"], params["we_up"],
              params["we_down"], x), (rep, None, None, None, rep),
        [yp, rep, rep])
    y = y.redistribute(mesh, x.placements).to(x.dtype)
    return y, {"moe_aux_loss": loss, "moe_drop_frac": drop}


def _form_on_dtensors(form, params: dict, x, cfg) -> Tuple[torch.Tensor,
                                                           dict]:
    """A sharded form (:func:`moe_apply_sharded`,
    :func:`moe_apply_capsharded`) on DTensors: each rank's local tokens
    and weights, as the reference's ``shard_map`` hands them (x by rows,
    the router whole, the expert weights as they are laid out); y comes
    back laid out as x, the aux values as every rank's own."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim

    def run(router, wg, wu, wd, xs):
        y, aux = form({"router": router, "we_gate": wg, "we_up": wu,
                       "we_down": wd}, xs, cfg, mesh)
        return y, aux["moe_aux_loss"], aux["moe_drop_frac"]
    y, loss, drop = local_call(
        run, (params["router"], params["we_gate"], params["we_up"],
              params["we_down"], x), (rep, None, None, None, None),
        [list(x.placements), rep, rep])
    return y, {"moe_aux_loss": loss, "moe_drop_frac": drop}


def _model_rank(mesh) -> tuple:
    return axis_sizes(mesh)["model"], mesh.get_local_rank("model")


def moe_sharded_local(params: dict, x: torch.Tensor, cfg, mesh,
                      window=(1, 0)) -> Tuple[torch.Tensor, dict]:
    """:func:`moe_apply_sharded` before its all-reduce: this rank's
    experts' share of y (of the claims in ``window`` of their capacity,
    :func:`_in_window`), summed in float32, and the local aux (no
    communication)."""
    n_model, r = _model_rank(mesh)
    e, k = cfg.n_experts, cfg.experts_per_token
    e_loc = e // n_model
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    cap = _capacity(t, cfg)          # from the local token count
    probs, gate, expert, flat_e, place = _route(params["router"], xt, cfg)
    keep = place < cap
    lo = r * e_loc
    mine, cap, at = _in_window(keep, place, cap, window)
    mine = mine & (flat_e >= lo) & (flat_e < lo + e_loc)
    slot = torch.where(mine, (flat_e - lo) * cap + at,
                       torch.full_like(place, e_loc * cap))
    w = [params[n] for n in ("we_gate", "we_up", "we_down")]
    if w[0].shape[0] == e and e_loc != e:   # whole experts: take my range
        w = [t_[lo:lo + e_loc] for t_ in w]
    buf = _dispatch(xt, slot, e_loc * cap, k).view(e_loc, cap, d)
    y = _combine(_experts(buf, *w), slot, gate, t, k, torch.float32)
    return y.reshape(shape), _aux(probs, expert, keep, cfg)


def moe_apply_sharded(params: dict, x: torch.Tensor, cfg,
                      mesh) -> Tuple[torch.Tensor, dict]:
    """Expert-parallel MoE over the mesh's ``model`` axis (the
    reference's ``moe_apply_sharded``, ``repro/models/moe.py:112``).
    Every rank routes its LOCAL tokens x (..., T_loc, D) with the
    replicated router (capacity from the local token count), dispatches
    the claims of its expert range ``[r * E_loc, (r + 1) * E_loc)`` into
    a local (E_loc, C, D) buffer, runs its experts (``params``' expert
    leaves (E_loc, D, F), or whole (E, D, F) of which it takes its
    range), gathers their outputs in token order and all-reduces y over
    ``model``: the one collective, O(T_loc * D).  A rank's share of y is
    summed and all-reduced in float32 and rounded to x's dtype once, so
    in bf16 y is the single-process :func:`moe_apply`'s up to the order
    of a float32 sum (the reference psums bf16 shares, each rounded).
    Aux values are the rank's local ones, as each device's shard of the
    reference's replicated scalars."""
    y, aux = moe_sharded_local(params, x, cfg, mesh)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.get_group("model"))
    return y.to(x.dtype), aux


def moe_capsharded_local(params: dict, x: torch.Tensor, cfg,
                         mesh) -> Tuple[torch.Tensor, dict]:
    """:func:`moe_apply_capsharded` before its all-reduce (y's share in
    float32)."""
    n_model, r = _model_rank(mesh)
    e, k = cfg.n_experts, cfg.experts_per_token
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    cap = _capacity(t, cfg)
    cap_loc = -(-cap // n_model)
    probs, gate, expert, flat_e, place = _route(params["router"], xt, cfg)
    keep = place < cap
    lo = r * cap_loc                 # my window of every expert's places
    mine = keep & (place >= lo) & (place < lo + cap_loc)
    slot = torch.where(mine, flat_e * cap_loc + (place - lo),
                       torch.full_like(place, e * cap_loc))
    buf = _dispatch(xt, slot, e * cap_loc, k).view(e, cap_loc, d)
    out = _experts(buf, params["we_gate"], params["we_up"], params["we_down"])
    y = _combine(out, slot, gate, t, k, torch.float32)
    return y.reshape(shape), _aux(probs, expert, keep, cfg)


def moe_apply_capsharded(params: dict, x: torch.Tensor, cfg,
                         mesh) -> Tuple[torch.Tensor, dict]:
    """Capacity-sharded MoE for E that does not divide the ``model``
    axis (the reference's ``moe_apply_capsharded``,
    ``repro/models/moe.py:208``): every rank holds every expert and
    processes its window ``[r * C_loc, (r + 1) * C_loc)`` of each
    expert's places, ``C_loc = ceil(C / n_model)``; one all-reduce of y
    over ``model``, in float32 and aux values as for
    :func:`moe_apply_sharded`."""
    y, aux = moe_capsharded_local(params, x, cfg, mesh)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.get_group("model"))
    return y.to(x.dtype), aux
