"""Grouped-query attention over the KV caches: decode and chunked
prefill, against paged pools or dense slot caches.

Port of the decode/chunk paths of ``repro/models/attention.py`` for
linear (``attn``) segments.  Rotary is applied to K at write time and
score math is f32, as in the reference.  The projections go through
``models/quantize.py::qdot``, so packed weights take the quant-matmul
kernel and plain ones run ``x @ w`` as before.

The caches are updated **in place**: the new tokens' K/V are written
with an index assignment into the tensors the caller passes — paged
pools ``(NB, bs, KV, hd)`` or a dense cache ``(B, S, KV, hd)`` of one
layer — which replaces the reference's functional ``.at[].set`` under
buffer donation.  The scores, softmax and value sum then run in a kernel
that reads the caches in place (``kernels/decode_attention.py``,
``kernels/flash_attention.py``).  A dense chunk reuses the paged
prefill kernel on a one-block view of the row's cache (block size S,
table ``[0]``), or, for B rows, on the cache as a pool of B blocks of S
slots (tables ``arange(B)[:, None]``).  The plain versions beside those
kernels repeat the reference's ``_gqa_scores`` / ``_gqa_out`` math.

A chunk takes ``pos`` in two forms: a host ``int`` for one request's
prefill chunk (batch 1, the one-row kernel), or a ``(B,)`` int32 tensor
for B rows at once, each at its own position (the draft-verify round,
``Model.verify_steps``; the batched kernel, which reads ``pos`` on the
device, so nothing here waits for the host).

Invariants (``repro/models/kvcache.py``): stale KV is masked by
position, and unallocated table entries point at the scratch block 0,
which inactive decode rows may write and nobody reads unmasked.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.decode_attention import (dense_decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.flash_attention import (paged_chunk_attention,
                                                 paged_prefill_attention)
from repro_torch.models.layers import _dense_init, rotary
from repro_torch.models.quantize import qdot


def attention_init(generator, cfg, dtype, device, n: int) -> dict:
    """``n`` stacked layers of q/k/v/o projections, ``(n, in, out)``."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _dense_init(generator, (n, d, h * hd), dtype, device),
        "wk": _dense_init(generator, (n, d, kv * hd), dtype, device),
        "wv": _dense_init(generator, (n, d, kv * hd), dtype, device),
        "wo": _dense_init(generator, (n, h * hd, d), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, h * hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((n, kv * hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((n, kv * hd), dtype=dtype, device=device)
    return p


def _proj_q(params, x, cfg):
    q = qdot(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    return q.reshape(*x.shape[:-1], cfg.n_heads, cfg.head_dim)


def _proj_kv(params, x, cfg):
    k = qdot(x, params["wk"])
    v = qdot(x, params["wv"])
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    k = k.reshape(*x.shape[:-1], cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(*x.shape[:-1], cfg.n_kv_heads, cfg.head_dim)
    return k, v


def _qkv(params, x, positions, cfg):
    """Projections of x (B,T,D) with rotary at ``positions`` (B|1, T)
    on q and the new k; returns (q, k_new, v_new), each (B,T,heads,hd)."""
    q = _proj_q(params, x, cfg)
    k_new, v_new = _proj_kv(params, x, cfg)
    return (rotary(q, positions, cfg.rope_theta),
            rotary(k_new, positions, cfg.rope_theta), v_new)


def _out(params, o, cfg):
    """The attention output (B,T,H,hd) through ``wo`` (``_gqa_out``)."""
    b, t = o.shape[:2]
    return qdot(o.reshape(b, t, cfg.n_heads * cfg.head_dim), params["wo"])


def _check_linear(kind, cfg):
    if kind != "attn" and not (kind == "swa" and not cfg.window):
        raise NotImplementedError(
            f"attention for block kind {kind!r} (window {cfg.window}) is "
            f"not ported yet")


def paged_decode_self_attention(params, x, cache: dict, paged: dict, pos,
                                cfg, kind: str) -> Tuple[torch.Tensor, dict]:
    """One-token decode against paged block pools.

    x: (B,1,D); cache {"k","v"}: (NB_phys, bs, KV, hd) pools of one
    layer, updated in place; paged["tables"] (B, nb) int32; pos (B,)
    int32 absolute position of the new token.  Returns (out (B,1,D),
    cache).
    """
    _check_linear(kind, cfg)
    b = x.shape[0]
    k_pool, v_pool = cache["k"], cache["v"]
    bs = k_pool.shape[1]
    tables = paged["tables"]
    max_len = tables.shape[1] * bs
    q, k_new, v_new = _qkv(params, x, pos[:, None], cfg)

    slot = torch.clamp(pos.long(), max=max_len - 1)
    bidx = torch.arange(b, device=x.device)
    phys = tables[bidx, slot // bs].long()
    off = slot % bs
    # rows of a decode batch own disjoint blocks; only inactive rows
    # share the scratch block (id 0), whose content is never read
    k_pool[phys, off] = k_new[:, 0]
    v_pool[phys, off] = v_new[:, 0]

    o = paged_decode_attention(q[:, 0], k_pool, v_pool, tables, pos)
    return _out(params, o[:, None], cfg), cache


def paged_chunk_self_attention(params, x, cache: dict, paged: dict, pos,
                               cfg, kind: str) -> Tuple[torch.Tensor, dict]:
    """C-token cache-resuming attention against paged pools.  Writes the
    chunk's K/V through the tables in place (slots clamped at
    ``max_len - 1``), then attends causally over ``[0, pos + C)``.
    ``pos`` is the absolute position of the chunk's first token: an
    ``int`` for one request's prefill chunk (x (1,C,D), paged["tables"]
    the row's slice (1, nb)), or a (B,) int32 tensor for B rows (x
    (B,C,D), tables (B, nb); the linear branch of the reference's
    ``paged_chunk_self_attention``).  Returns (out (B,C,D), cache).
    """
    _check_linear(kind, cfg)
    b, c, _ = x.shape
    k_pool, v_pool = cache["k"], cache["v"]
    bs = k_pool.shape[1]
    tables = paged["tables"]
    max_len = tables.shape[1] * bs
    if torch.is_tensor(pos):
        # writes past a row's covered blocks land in the scratch block 0;
        # duplicate scatter indices can only hit it or a row's clamped
        # last slot, neither read below a row's accepted length, so which
        # duplicate wins does not matter (as in the reference)
        positions = pos.long()[:, None] + torch.arange(c, device=x.device)
        q, k_new, v_new = _qkv(params, x, positions, cfg)
        slots = torch.clamp(positions, max=max_len - 1)
        bidx = torch.arange(b, device=x.device)[:, None]
        phys = tables[bidx, slots // bs].long()
        off = slots % bs
        k_pool[phys, off] = k_new
        v_pool[phys, off] = v_new
        o = paged_chunk_attention(q, k_pool, v_pool, tables, pos)
        return _out(params, o, cfg), cache
    if b != 1:
        raise ValueError(f"paged chunk attention at a host pos prefills one "
                         f"request, got a batch of {b}")
    table = tables[0]
    pos = int(pos)
    positions = pos + torch.arange(c, device=x.device)
    q, k_new, v_new = _qkv(params, x, positions[None, :], cfg)

    slots = torch.clamp(positions, max=max_len - 1)
    phys = table[slots // bs].long()
    off = slots % bs
    k_pool[phys, off] = k_new[0]
    v_pool[phys, off] = v_new[0]

    o = paged_prefill_attention(q[0], k_pool, v_pool, table, pos)
    return _out(params, o[None], cfg), cache


def decode_self_attention(params, x, cache: dict, pos, cfg,
                          kind: str) -> Tuple[torch.Tensor, dict]:
    """One-token decode against dense slot caches.

    x: (B,1,D); cache {"k","v"}: (B, S, KV, hd) of one layer, updated in
    place; pos (B,) int32 absolute position of the new token.  The new
    K/V lands at slot ``min(pos, S - 1)``, as in the reference's linear
    cache.  Returns (out (B,1,D), cache).
    """
    _check_linear(kind, cfg)
    b = x.shape[0]
    k_cache, v_cache = cache["k"], cache["v"]
    q, k_new, v_new = _qkv(params, x, pos[:, None], cfg)
    slot = torch.clamp(pos.long(), max=k_cache.shape[1] - 1)
    bidx = torch.arange(b, device=x.device)
    k_cache[bidx, slot] = k_new[:, 0]
    v_cache[bidx, slot] = v_new[:, 0]
    o = dense_decode_attention(q[:, 0], k_cache, v_cache, pos)
    return _out(params, o[:, None], cfg), cache


def chunk_self_attention(params, x, cache: dict, pos, cfg,
                         kind: str) -> Tuple[torch.Tensor, dict]:
    """C-token cache-resuming attention against dense cache rows: the
    linear branch of the reference's ``chunk_self_attention``.  Writes
    the chunk at slots ``min(pos + i, S - 1)``, then attends causally
    over ``[0, pos + C)``.  ``pos`` is an ``int`` for one slot's prefill
    chunk (x (1,C,D), cache {"k","v"} the slot's (1, S, KV, hd) views of
    one layer, written in place; the paged prefill kernel on the row as
    one block of S slots), or a (B,) int32 tensor for B rows (x (B,C,D),
    cache (B, S, KV, hd); the batched kernel on the cache as B blocks of
    S slots).  Returns (out (B,C,D), cache).
    """
    _check_linear(kind, cfg)
    b, c, _ = x.shape
    k_cache, v_cache = cache["k"], cache["v"]
    if torch.is_tensor(pos):
        # duplicate scatter indices only at a row's clamped last slot,
        # never read below its accepted length
        positions = pos.long()[:, None] + torch.arange(c, device=x.device)
        q, k_new, v_new = _qkv(params, x, positions, cfg)
        slots = torch.clamp(positions, max=k_cache.shape[1] - 1)
        bidx = torch.arange(b, device=x.device)[:, None]
        k_cache[bidx, slots] = k_new
        v_cache[bidx, slots] = v_new
        tables = torch.arange(b, dtype=torch.int32, device=x.device)[:, None]
        o = paged_chunk_attention(q, k_cache, v_cache, tables, pos)
        return _out(params, o, cfg), cache
    if b != 1:
        raise ValueError(f"dense chunk attention at a host pos prefills one "
                         f"slot, got a batch of {b}")
    pos = int(pos)
    positions = pos + torch.arange(c, device=x.device)
    q, k_new, v_new = _qkv(params, x, positions[None, :], cfg)
    slots = torch.clamp(positions, max=k_cache.shape[1] - 1)
    k_cache[0, slots] = k_new[0]
    v_cache[0, slots] = v_new[0]
    table = torch.zeros(1, dtype=torch.int32, device=x.device)
    o = paged_prefill_attention(q[0], k_cache, v_cache, table, pos)
    return _out(params, o[None], cfg), cache
