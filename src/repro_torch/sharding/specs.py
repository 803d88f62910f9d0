"""Sharding rules: logical activation / parameter names -> partition specs.

The port's copy of ``repro/sharding/specs.py``.  A spec is a
:class:`PartitionSpec`: one entry per tensor dim, each a mesh-axis name,
a tuple of names (the dim sharded over their product, in that order) or
None (replicated).  Meshes are :class:`torch.distributed.device_mesh.
DeviceMesh` objects with named dims, or anything whose ``shape`` maps axis
names to sizes (so the 16x16 and 2x16x16 production meshes can be
reasoned about with no 256 ranks): :func:`axis_sizes` reads either.

Model code calls :func:`constrain` with a *logical* name.  Outside
:func:`use_mesh_rules` it returns its input; inside, a DTensor is
redistributed to the rule's placements (:func:`to_placements`, the
counterpart of ``NamedSharding``), non-dividing axes dropped, and a plain
tensor is returned as it is: it is already the rank's local shard, as
inside a ``shard_map`` body.

Logical axes:
  * data axes ("data", and "pod" when multi-pod) shard the batch;
  * "model" shards heads / ffn-hidden / experts / vocab / d_inner.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import torch

_state = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dim: an axis name, a tuple of names, or None.
    A one-name tuple is kept as the name, as ``jax.sharding.PartitionSpec``
    keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_names(mesh) -> tuple:
    """The mesh's axis names, in order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names)
    names = getattr(mesh, "axis_names", None)
    return tuple(names) if names is not None else tuple(mesh.shape)


def axis_sizes(mesh) -> dict:
    """Axis name -> size, of a DeviceMesh or of a ``shape`` mapping."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _batch_axes(mesh):
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def sharding_rules(mesh) -> dict:
    """Logical activation name -> PartitionSpec for this mesh; a list is
    a fallback chain (the first candidate that fits wins)."""
    b = _batch_axes(mesh)
    return {
        # activations
        "act_btd": P(b, None, None),          # (batch, seq, d_model)
        "act_btf": P(b, None, "model"),       # (batch, seq, d_ff)
        "act_btv": P(b, None, "model"),       # (batch, seq, vocab)
        "act_bthd": P(b, None, "model", None),  # (batch, seq, heads, head_dim)
        "act_btkv": P(b, None, None, None),   # kv heads usually < model axis
        "kv_cache_heads": P(b, None, None, None),
        "kv_cache_seq": P(b, "model", None, None),  # seq-parallel decode cache
        "ssm_state": P(b, "model", None),     # (batch, d_inner, d_state)
        # (experts, cap, d_model): expert-parallel when E divides the model
        # axis, else shard the capacity dim
        "moe_buf": (
            # ep_dp: also shard capacity over the data axes, so expert
            # FLOPs scale with data parallelism
            [P("model", b, None), P("model", None, None),
             P(None, b + ("model",), None), P(None, "model", None)]
            if os.environ.get("REPRO_MOE_LAYOUT") == "ep_dp" else
            [P("model", None, None), P(None, "model", None)]),
    }


def param_spec(path: str, shape: tuple, mesh) -> PartitionSpec:
    """PartitionSpec for a parameter identified by its path.

    Heuristics keyed on the leaf's name; divisibility is checked and
    falls back to replication per dim.  A path starting ``seg:`` has a
    leading layer dim, which is never sharded: every block leaf of the
    port carries one (:func:`param_specs`), so a one-layer segment's and
    the shared set's specs are the reference's with one leading None.
    """
    size = axis_sizes(mesh).get("model", 1)

    def ok(dim):
        return dim % size == 0 and dim >= size

    leaf = path.split("/")[-1]
    offset = 1 if path.startswith("seg:") else 0
    spec = [None] * len(shape)

    def set_model(dim_idx):
        if 0 <= dim_idx < len(shape) and ok(shape[dim_idx]):
            spec[dim_idx] = "model"

    if leaf in ("w_gate", "w_up"):
        set_model(offset + 1)
    elif leaf == "w_down":
        set_model(offset + 0)
    elif leaf in ("wq", "wo"):
        # wq: (d, H*hd) sharded on heads; wo: (H*hd, d) sharded dim0
        set_model(offset + (1 if leaf == "wq" else 0))
    elif leaf in ("wk", "wv"):
        set_model(offset + 1)  # replicated if kv*hd % size != 0
    elif leaf == "w" and ("embed" in path or "lm_head" in path):
        set_model(offset + 0)
    elif leaf in ("we_gate", "we_up", "we_down"):
        # expert weights: (E, d, f) / (E, f, d) -- prefer the expert dim
        if ok(shape[offset + 0]):
            spec[offset + 0] = "model"
        else:  # tensor-parallel inside experts
            hid = offset + (2 if leaf in ("we_gate", "we_up") else 1)
            set_model(hid)
    elif leaf in ("in_proj", "out_proj"):
        set_model(offset + (1 if leaf == "in_proj" else 0))
    elif leaf in ("conv_w", "A_log", "D", "dt_bias", "x_proj", "dt_proj"):
        # mamba internals: shard the last dividing dim past the layer dim
        for i in range(len(shape) - 1, offset - 1, -1):
            if ok(shape[i]):
                spec[i] = "model"
                break
    return P(*spec)


def param_specs(params, mesh, prefix: str = "") -> object:
    """:func:`param_spec` of every leaf of a port parameter tree (nested
    dicts and lists; leaves anything with a ``shape``, None kept), in the
    same structure.  Leaves under ``segments`` or ``shared`` carry the
    port's leading layer dim and take the ``seg:`` path."""
    if params is None:
        return None
    if isinstance(params, dict):
        return {k: param_specs(v, mesh, f"{prefix}{k}/")
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [param_specs(v, mesh, f"{prefix}{i}/")
                for i, v in enumerate(params)]
    path = prefix[:-1]
    keys = path.split("/")
    seg = "segments" in keys or "shared" in keys
    return param_spec(("seg:" if seg else "") + path, tuple(params.shape),
                      mesh)


@contextlib.contextmanager
def use_mesh_rules(mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    _state.rules = sharding_rules(mesh) if mesh is not None else None
    try:
        yield
    finally:
        _state.mesh = prev
        _state.rules = sharding_rules(prev) if prev is not None else None


def current_mesh():
    return getattr(_state, "mesh", None)


def _fits(dim: int, ax, mesh) -> bool:
    if ax is None:
        return True
    sizes = axis_sizes(mesh)
    axes = ax if isinstance(ax, tuple) else (ax,)
    n = 1
    for a in axes:
        n *= sizes[a]
    return dim % n == 0 and dim >= n


def fit_spec(shape: tuple, spec, mesh) -> PartitionSpec:
    """``spec`` with non-dividing axes dropped, padded with None to the
    tensor's rank (the reference returns it wrapped in a NamedSharding;
    :func:`to_placements` is that step here)."""
    fixed = [ax if _fits(d, ax, mesh) else None for d, ax in zip(shape, spec)]
    return P(*(fixed + [None] * (len(shape) - len(fixed))))


def _rule_spec(shape: tuple, name: str, mesh) -> Optional[PartitionSpec]:
    """The rule ``name``'s spec for a tensor of ``shape``, the fallback
    chain resolved and non-dividing axes dropped, or None where no rule
    applies (an unknown name, another rank)."""
    rules = _state.rules
    if name not in rules:
        return None
    spec = rules[name]
    if isinstance(spec, list):  # fallback chain: first fully-applicable wins
        chosen = None
        for cand in spec:
            if len(cand) != len(shape):
                continue
            if all(_fits(shape[i], cand[i], mesh) for i in range(len(shape))):
                chosen = cand
                break
        spec = chosen if chosen is not None else spec[0]
    if len(spec) != len(shape):
        return None
    return fit_spec(shape, spec, mesh)


def to_placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on a DeviceMesh: each mesh dim
    shards the tensor dim whose entry names it (``Shard``), else
    ``Replicate``; a dim sharded over several axes is split over them in
    mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dims = [i for i, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def constrain(x, name: str):
    """``x`` laid out by the rule ``name`` under :func:`use_mesh_rules`:
    a DTensor redistributed to the rule's placements, a plain tensor (a
    rank's local shard) as it is; ``x`` itself outside a mesh."""
    mesh = getattr(_state, "mesh", None)
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = _rule_spec(tuple(x.shape), name, mesh)
    if spec is None:
        return x
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


def local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` under ``spec`` on a
    DeviceMesh (what ``shard_map``'s in_specs hand each device): each
    sharded dim cut into equal contiguous blocks, over a tuple of axes in
    their order (the first the slowest).  A view where the cut allows."""
    sizes = axis_sizes(mesh)
    names = axis_names(mesh)
    coord = mesh.get_coordinate()
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n, idx = 1, 0
        for a in axes:
            idx = idx * sizes[a] + coord[names.index(a)]
            n *= sizes[a]
        if t.shape[dim] % n:
            raise ValueError(f"local_shard: dim {dim} of {tuple(t.shape)} "
                             f"does not divide over {axes} ({n})")
        step = t.shape[dim] // n
        t = t.narrow(dim, idx * step, step)
    return t
