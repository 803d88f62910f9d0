"""Grouped-query attention over paged KV pools: decode and chunked prefill.

Port of the paged paths of ``repro/models/attention.py`` for linear
(``attn``) segments.  Rotary is applied to K at write time and score
math is f32, as in the reference.

The pools are updated **in place**: the new tokens' K/V are written
with an index assignment into the ``(NB, bs, KV, hd)`` pool tensors the
caller passes, which replaces the reference's functional
``.at[].set`` under buffer donation.  The scores, softmax and value sum
then run in a kernel that reads the pools through the block tables
(``kernels/decode_attention.py``, ``kernels/flash_attention.py``).  The
plain versions beside those kernels repeat the reference's
``_gqa_scores`` / ``_gqa_out`` math on the gathered logical view.

Invariants (``repro/models/kvcache.py``): stale KV is masked by
position, and unallocated table entries point at the scratch block 0,
which inactive decode rows may write and nobody reads unmasked.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.flash_attention import paged_prefill_attention
from repro_torch.models.layers import _dense_init, rotary


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
    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    return q.reshape(*x.shape[:-1], cfg.n_heads, cfg.head_dim)


def _proj_kv(params, x, cfg):
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    k = k.reshape(*x.shape[:-1], cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(*x.shape[:-1], cfg.n_kv_heads, cfg.head_dim)
    return k, v


def _check_linear(kind, cfg):
    if kind != "attn" and not (kind == "swa" and not cfg.window):
        raise NotImplementedError(
            f"paged attention for block kind {kind!r} (window "
            f"{cfg.window}) is not ported yet")


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
    q = _proj_q(params, x, cfg)
    k_new, v_new = _proj_kv(params, x, cfg)
    q = rotary(q, pos[:, None], cfg.rope_theta)
    k_new = rotary(k_new, pos[:, None], cfg.rope_theta)

    slot = torch.clamp(pos.long(), max=max_len - 1)
    bidx = torch.arange(b, device=x.device)
    phys = tables[bidx, slot // bs].long()
    off = slot % bs
    # rows of a decode batch own disjoint blocks; only inactive rows
    # share the scratch block (id 0), whose content is never read
    k_pool[phys, off] = k_new[:, 0]
    v_pool[phys, off] = v_new[:, 0]

    o = paged_decode_attention(q[:, 0], k_pool, v_pool, tables, pos)
    out = o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ params["wo"]
    return out, cache


def paged_chunk_self_attention(params, x, cache: dict, paged: dict, pos: int,
                               cfg, kind: str) -> Tuple[torch.Tensor, dict]:
    """C-token cache-resuming attention against paged pools (chunked
    prefill of ONE request: x (1,C,D), paged["tables"] the row's slice
    (1, nb)).  Writes the chunk's K/V through the table in place, then
    attends causally over ``[0, pos + C)``.  ``pos`` is the absolute
    position of the chunk's first token.  Returns (out (1,C,D), cache).
    """
    _check_linear(kind, cfg)
    b, c, _ = x.shape
    if b != 1:
        raise ValueError(f"paged chunk attention prefills one request, "
                         f"got a batch of {b}")
    k_pool, v_pool = cache["k"], cache["v"]
    bs = k_pool.shape[1]
    table = paged["tables"][0]
    max_len = table.shape[0] * bs
    pos = int(pos)
    positions = pos + torch.arange(c, device=x.device)
    q = _proj_q(params, x, cfg)
    k_new, v_new = _proj_kv(params, x, cfg)
    q = rotary(q, positions[None, :], cfg.rope_theta)
    k_new = rotary(k_new, positions[None, :], cfg.rope_theta)

    slots = torch.clamp(positions, max=max_len - 1)
    phys = table[slots // bs].long()
    off = slots % bs
    k_pool[phys, off] = k_new[0]
    v_pool[phys, off] = v_new[0]

    o = paged_prefill_attention(q[0], k_pool, v_pool, table, pos)
    out = o.reshape(1, c, cfg.n_heads * cfg.head_dim) @ params["wo"]
    return out, cache
