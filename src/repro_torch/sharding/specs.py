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
inside a ``shard_map`` body.  :func:`reshape_constrain` is a reshape
that splits a sharded last dim followed by :func:`constrain`: DTensor
refuses to split a dim sharded unevenly over the new dims, so the flat
tensor is first laid out as the rule wants the split one (the step
GSPMD takes implicitly).  :func:`local_call` runs a function on each
rank's local tensors of DTensor arguments (a kernel, or a region whose
operations DTensor has no rule for) and wraps its outputs back.

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
    mesh order.  A mesh dim of size 1 replicates (a shard of everything
    is the whole, and DTensor would refuse to flatten such a dim)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for i, name in enumerate(axis_names(mesh)):
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims and mesh.size(i) > 1
                   else Replicate())
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


def is_dtensor(x) -> bool:
    """Is ``x`` a DTensor (under a mesh: the only time one can be)?"""
    if getattr(_state, "mesh", None) is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def reshape_constrain(x, shape: tuple, name: str):
    """``constrain(x.reshape(shape), name)`` where ``shape`` splits x's
    last dim in two (a projection into heads).  A DTensor is first
    redistributed to the placements of the rule's spec for ``shape``
    with the two split dims merged: sharded as the first of them where
    the rule shards it, else replicated, so that the split is local."""
    if not is_dtensor(x):
        return constrain(x.reshape(shape), name)
    mesh = x.device_mesh
    spec = _rule_spec(tuple(shape), name, mesh) or P(*([None] * len(shape)))
    flat = list(spec[:-2]) + [spec[-2] if spec[-1] is None else None]
    x = x.redistribute(mesh, to_placements(flat, mesh))
    return constrain(x.reshape(shape), name)


def reshape_merged(x, shape: tuple):
    """``x.reshape(shape)`` where ``shape`` merges x's last two dims
    (heads back into one projection).  A DTensor's merged dim is then
    sharded over ``model`` where that divides it, as the projection that
    reads it shards its input: the gradient that comes back sharded so
    is laid out whole again before the reshape's gradient splits it
    (DTensor refuses to split a dim sharded unevenly over the heads)."""
    y = x.reshape(shape)
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import Replicate, Shard
    mesh = y.device_mesh
    names = axis_names(mesh)
    if "model" not in names:
        return y
    i = names.index("model")
    pl = list(y.placements)
    if not isinstance(pl[i], Replicate) or shape[-1] % mesh.size(i):
        return y
    pl[i] = Shard(len(shape) - 1)
    return y.redistribute(mesh, pl)


def keep_placements(x, whole=()) -> list:
    """x's placements with every dim of ``whole`` (a dim a function
    needs whole on each rank) made replicated."""
    from torch.distributed.tensor import Replicate, Shard
    whole = {d % x.ndim for d in whole}
    return [Replicate() if isinstance(p, Shard) and p.dim in whole else p
            for p in x.placements]


def replicated(x) -> list:
    """Replicated on every dim of x's mesh."""
    from torch.distributed.tensor import Replicate
    return [Replicate()] * x.device_mesh.ndim


def local_call(fn, args: tuple, placements: tuple, out_placements):
    """``fn(*locals)``: each DTensor of ``args`` redistributed to its
    entry of ``placements`` (None: as it is) and taken local; other args
    passed as they are.  Each tensor output is wrapped as a DTensor on
    the first DTensor arg's mesh with its entry of ``out_placements``
    (one list of placements a tensor output, in order; a single output
    takes the list itself), non-tensors as they are.  The sharded dims
    must divide evenly (the rules' ``fit_spec`` sees to that).

    Gradients: a mesh dim on which some output is sharded or partial
    splits the work, so an input replicated on it gets only this rank's
    share of its gradient: a ``Partial`` there.  An output replicated on
    such a dim is the same on every rank of it, so the gradient it
    passes back is divided by the dim's size, and those partial shares
    sum to it once.  Elsewhere a gradient takes its input's
    placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    single = not out_placements or not isinstance(out_placements[0],
                                                  (list, tuple))
    outs = [out_placements] if single else out_placements
    split = {j for pl in outs for j, p in enumerate(pl)
             if not isinstance(p, Replicate)}
    local = []
    for a, pl in zip(args, placements):
        if isinstance(a, DTensor):
            pl = list(a.placements) if pl is None else list(pl)
            if list(a.placements) != pl:
                a = a.redistribute(mesh, pl)
            a = a.to_local(grad_placements=[
                Partial() if j in split and isinstance(p, Replicate) else p
                for j, p in enumerate(pl)])
        local.append(a)
    out = fn(*local)

    def wrap(o, pl):
        if o.requires_grad and torch.is_grad_enabled():
            n = 1
            for j in split:
                if isinstance(pl[j], Replicate):
                    n *= mesh.size(j)
            if n > 1:
                o = _ScaleGrad.apply(o, 1.0 / n)
        return _from_local(o, mesh, pl)
    if torch.is_tensor(out):
        return wrap(out, out_placements)
    wrapped, i = [], 0
    for o in out:
        if torch.is_tensor(o):
            o = wrap(o, out_placements[i])
            i += 1
        wrapped.append(o)
    return type(out)(wrapped)


class _ScaleGrad(torch.autograd.Function):
    """The identity, its gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _from_local(t, mesh, placements):
    """``DTensor.from_local`` of an evenly sharded local; a contiguous
    local makes a contiguous DTensor (from_local's own strides scale a
    size-1 dim's stride, which stops matmul from folding the batch dims
    and sends it through an expanded weight)."""
    from torch.distributed.tensor import DTensor, Shard
    shape = list(t.shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.size(i)
    stride = None
    if t.is_contiguous():
        stride = [1] * len(shape)
        for d in range(len(shape) - 2, -1, -1):
            stride[d] = stride[d + 1] * shape[d + 1]
        stride = tuple(stride)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


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
