"""Distributed flash-decode: a sequence-parallel KV cache over a mesh axis.

The port of ``repro/serving/decode.py``.  The dense cache ``(B, S, KV,
hd)`` shards along the *sequence* dim over the ``model`` axis (and the
batch over the data axes): :func:`decode_specs`.  Each rank runs the
dense decode kernel's partials form over its slice
(``kernels/decode_attention.py::dense_decode_attention_partial``), then
the softmax partials (m, l, acc) combine with one all-reduce MAX and two
all-reduce SUMs over the axis's process group: O(B·H·hd) values on the
wire; the cache is never gathered.

The caller hands each rank what a ``shard_map`` body gets: its local q,
pos and cache slice (:func:`repro_torch.sharding.specs.local_shard` cuts
them from whole tensors).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.decode_attention import (
    dense_decode_attention_partial)
from repro_torch.sharding.specs import PartitionSpec as P
from repro_torch.sharding.specs import axis_names


def _batch_axes(mesh, batch_axes) -> tuple:
    """``batch_axes`` where the mesh has them all, else none."""
    names = axis_names(mesh)
    return tuple(batch_axes) if all(a in names for a in batch_axes) else ()


def decode_specs(mesh, axis: str = "model",
                 batch_axes=("data",)) -> tuple:
    """The specs of q (B,H,hd), the caches (B,S,KV,hd) and pos (B,) that
    :func:`distributed_decode_attention` takes its local slices by (the
    reference's in_specs, in the port's cache layout)."""
    ba = _batch_axes(mesh, batch_axes) or None
    return (P(ba, None, None), P(ba, axis, None, None), P(ba))


def distributed_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, pos: torch.Tensor,
                                 mesh, axis: str = "model",
                                 batch_axes=("data",),
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """This rank's q (B_loc,H,hd), cache slice (B_loc,S_loc,KV,hd) and
    pos (B_loc,) int32 (logical positions over the whole sequence) ->
    its rows' attention output (B_loc,H,hd) in q's dtype.  The slice
    starts at logical slot ``rank-on-axis * S_loc``.  ``batch_axes``
    name the axes the batch is cut over (:func:`decode_specs`); they drop
    out where the mesh lacks them."""
    d = q.shape[-1]
    s_loc = k_cache.shape[1]
    scale = d ** -0.5 if scale is None else scale
    s_start = mesh.get_local_rank(axis) * s_loc
    group = mesh.get_group(axis)
    acc, m, l = dense_decode_attention_partial(q, k_cache, v_cache, pos,
                                               s_start, scale)
    # combine the partial softmax states across the seq shards
    m_glob = m.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_glob)
    acc = acc * corr
    l = l * corr
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(l, op=dist.ReduceOp.SUM, group=group)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
