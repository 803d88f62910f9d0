"""Grouped-query attention over the KV caches: decode and chunked
prefill, against paged pools or dense slot caches.

Port of the decode/chunk paths of ``repro/models/attention.py`` for
linear (``attn``) segments and sliding-window (``swa``) ones, whose
cache is a ring of ``w = min(window, max_len)`` slots: position p lives
at slot ``p % w``, through the row's ``swa_tables`` on the paged path.
Rotary is applied to K at write time and score math is f32, as in the
reference.  The projections go through
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

The ring orders its writes as the reference does.  A chunk attends
first (``kernels/flash_attention.py::ring_chunk_attention``, over the
old ring plus the chunk's own keys) and then writes its last
``min(C, w)`` keys into the ring: a write before the scores would
clobber old slots that earlier queries of the chunk still see.  A
decode step writes its key at slot ``pos % w`` first and then runs the
linear decode kernels with ``pos`` clamped at ``w - 1``: the ring's
valid slots (the reference's ``_decode_valid(ring=True)``) are exactly
``[0, min(pos, w - 1)]``, which is what those kernels read for the
clamped pos, so no decode kernel changes.  The batched chunk form (a
verify round) has no ring branch: speculation is gated off for a
windowed ``swa`` model, as in the reference.

Full-sequence attention (train mode, :func:`self_attention`) runs the
contiguous form of the flash kernel through
:class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`, whose
gradient is torch ops; the kernel reads the model's ``(B, S, heads,
hd)`` projections in place, as transposed views.

Cross-attention (``cross`` layers over image patches, an encoder-decoder's
``enc_xattn`` over the encoder's output) has no rotary and no mask: a
query attends to every one of the ``src`` source slots, whose K/V
:func:`make_cross_kv` projects once (``Model.prefill``) into the cross
caches, dense ``(B, src, KV, hd)`` rows or the paged engine's cross
pools ``(NB, bs, KV, hd)`` read in place through ``cross_tables``
(:func:`paged_cross_view`).  A decode step reads them with the decode
kernels at ``pos = src - 1`` for every row (all slots valid, the tail of
the last block masked); a chunk, and ``Model.prefill``, with the flash
kernel's cross form (``kernels/flash_attention.py::paged_cross_attention``,
keys ``[0, src)``, no causal mask), a dense cache taken as B blocks of
``src`` slots through identity tables; in train mode the same form
through :class:`~repro_torch.kernels.flash_attention.CrossAttentionFn`,
whose gradient (to the queries and to the projected source K/V) is torch
ops.

Invariants (``repro/models/kvcache.py``): stale KV is masked by
position, and unallocated table entries point at the scratch block 0,
which inactive decode rows may write and nobody reads unmasked.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels.decode_attention import (dense_decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.flash_attention import (CrossAttentionFn,
                                                 FlashAttentionFn,
                                                 paged_chunk_attention,
                                                 paged_cross_attention,
                                                 paged_prefill_attention,
                                                 ring_chunk_attention)
from repro_torch.models.layers import _dense_init, rotary
from repro_torch.models.quantize import qdot
from repro_torch.sharding.specs import (is_dtensor, local_call,
                                        reshape_constrain, reshape_merged)


def attention_init(generator, cfg, dtype, device, n: int,
                   cross: bool = False) -> dict:
    """``n`` stacked layers of q/k/v/o projections, ``(n, in, out)``; a
    cross-attention (``cross``) has no qkv bias, as in the reference."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _dense_init(generator, (n, d, h * hd), dtype, device),
        "wk": _dense_init(generator, (n, d, kv * hd), dtype, device),
        "wv": _dense_init(generator, (n, d, kv * hd), dtype, device),
        "wo": _dense_init(generator, (n, h * hd, d), dtype, device),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((n, h * hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((n, kv * hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((n, kv * hd), dtype=dtype, device=device)
    return p


def _kv_range(n_heads: int, n_kv: int, rank: int, size: int):
    """The KV heads (first, count) that query heads ``[rank * H / size,
    (rank + 1) * H / size)`` read, or None where they do not map onto a
    contiguous run of whole groups, or of one group."""
    if n_heads % size:
        return None
    h_l, g = n_heads // size, n_heads // n_kv
    if h_l % g == 0:
        return rank * h_l // g, h_l // g
    if g % h_l == 0:
        return rank * h_l // g, 1
    return None


def _head_placements(q, n_kv: int, qh: int, kvh: int, cache=None):
    """Placements (q's, K/V's) and the sliced mesh dim for a kernel that
    reads q (heads on dim ``qh``) against K/V (KV heads on ``kvh``) on
    each rank: the rows (dim 0) where q shards them, q's heads where q
    shards them, K/V's heads with them where the KV heads divide (else K
    / V whole and each rank reads the KV heads its query heads map to:
    :func:`_kv_range`), anything else whole.  ``cache`` (a DTensor K/V
    cache, whose placements stay as they are) fixes K/V's instead: its
    rows and KV heads where it shards them, its slots (dim 1) sharded
    sequence-parallel (q whole along that mesh dim)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    qp, kp, sliced, seq = [], [], None, None
    for i, p in enumerate(q.placements):
        size = mesh.size(i)
        cp = None if cache is None else cache.placements[i]
        rows = isinstance(p, Shard) and p.dim == 0
        heads = isinstance(p, Shard) and p.dim == qh
        if cache is not None and isinstance(cp, Shard) and cp.dim == 1:
            qp.append(Replicate()), kp.append(cp)
            seq = i
        elif cache is not None and isinstance(cp, Shard):
            qp.append(Shard(0) if cp.dim == 0 else Shard(qh)), kp.append(cp)
        elif cache is None and rows:
            qp.append(Shard(0)), kp.append(Shard(0))
        elif heads and n_kv % size == 0 and cache is None:
            qp.append(Shard(qh)), kp.append(Shard(kvh))
        elif heads and sliced is None and _kv_range(
                q.shape[qh], n_kv, 0, size) is not None:
            qp.append(Shard(qh)), kp.append(Replicate())
            sliced = i
        else:
            qp.append(Replicate()), kp.append(Replicate())
    return qp, kp, sliced, seq


def _narrow_kv(mesh, sliced, n_heads: int, n_kv: int, kvh: int, *kv):
    """This rank's KV heads of whole K/V (:func:`_kv_range`)."""
    if sliced is None:
        return kv
    lo, n = _kv_range(n_heads, n_kv, mesh.get_local_rank(sliced),
                      mesh.size(sliced))
    return tuple(t.narrow(kvh, lo, n) for t in kv)


def _attend(fn, q, k, v, qh: int, kvh: int):
    """``fn(q, k, v)``, a kernel's wrapper (or autograd function) whose
    output has q's layout; on DTensors, on each rank's rows and heads
    (:func:`_head_placements`)."""
    if not is_dtensor(q):
        return fn(q, k, v)
    n_heads, n_kv = q.shape[qh], k.shape[kvh]
    qp, kp, sliced, _ = _head_placements(q, n_kv, qh, kvh)
    mesh = q.device_mesh

    def run(q, k, v):
        return fn(q, *_narrow_kv(mesh, sliced, n_heads, n_kv, kvh, k, v))
    return local_call(run, (q, k, v), (qp, kp, kp), qp)


def _proj_q(params, x, cfg):
    q = qdot(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    return reshape_constrain(q, (*x.shape[:-1], cfg.n_heads, cfg.head_dim),
                             "act_bthd")


def _proj_kv(params, x, cfg):
    k = qdot(x, params["wk"])
    v = qdot(x, params["wv"])
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    shape = (*x.shape[:-1], cfg.n_kv_heads, cfg.head_dim)
    return (reshape_constrain(k, shape, "act_btkv"),
            reshape_constrain(v, shape, "act_btkv"))


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
    return qdot(reshape_merged(o, (b, t, cfg.n_heads * cfg.head_dim)),
                params["wo"])


def _is_ring(kind, cfg) -> bool:
    """Does a ``kind`` layer keep a sliding-window ring (``swa`` with a
    window; a windowless ``swa`` is full attention)?"""
    if kind not in ("attn", "swa"):
        raise NotImplementedError(f"attention for block kind {kind!r} is "
                                  f"not ported yet")
    return kind == "swa" and bool(cfg.window)


def self_attention(params, x, positions, cfg, kind: str,
                   causal: bool = True) -> Tuple[torch.Tensor, dict]:
    """Full-sequence self-attention (the reference's ``self_attention``,
    train mode): the Q/K/V projections of x (B,S,D), rotary at
    ``positions`` (B|1, S), then the contiguous flash kernel with the
    window ``cfg.window`` for ``swa`` and none for ``attn`` (a causal
    window only), then the O product.  The kernel reads q (B,S,H,hd) and
    k / v (B,S,KV,hd) in place, as (B, heads, S, hd) views, and writes
    its output in q's layout, so the O product reads it without a copy.
    Returns (out (B,S,D), {"k","v"})."""
    _is_ring(kind, cfg)              # refuses kinds other than attn / swa
    q, k, v = _qkv(params, x, positions, cfg)
    window = cfg.window if kind == "swa" else 0
    def flash(q, k, v):        # (B,S,heads,hd) in, q's layout out
        return FlashAttentionFn.apply(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal, window,
                                      None).transpose(1, 2)
    return _out(params, _attend(flash, q, k, v, 2, 2), cfg), {"k": k, "v": v}


@functools.lru_cache(maxsize=None)
def _rows_at(b: int, value: int, device) -> torch.Tensor:
    """A (b,) int32 tensor of ``value`` on ``device``, built once per
    shape: the ``pos`` of a cross read (``src - 1``, every slot valid);
    real even under the dry-run's fake mode (:func:`layers._rotary_freq`)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return torch.full((b,), value, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _identity_tables(b: int, device) -> torch.Tensor:
    """Tables (b, 1) that take a dense cache (B, S, KV, hd) as a pool of B
    blocks of S slots, row r's block being r; built once per shape (and
    real under a fake mode, as :func:`_rows_at`)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return torch.arange(b, dtype=torch.int32, device=device)[:, None]


def make_cross_kv(params, src, cfg) -> dict:
    """K/V (B, S, KV, hd) of a source (B, S, D) (image patches or the
    encoder's output), no rotary: the reference's ``make_cross_kv``."""
    k, v = _proj_kv(params, src, cfg)
    return {"k": k, "v": v}


def paged_cross_view(cache: dict, paged: dict, src: int) -> dict:
    """The rows' cross K/V over paged pools: the layer's cross pools
    ``xk`` / ``xv`` (NB, bs, KV, hd), the rows' ``cross_tables`` (B,
    nb_cross) and the source length.  Where the reference's
    ``paged_cross_view`` gathers each row's first ``src`` slots into
    (B, src, KV, hd), the port's kernels read the pools in place through
    the tables (``kernels.decode_attention.paged_gather`` gives the
    reference's view)."""
    return {"k": cache["xk"], "v": cache["xv"],
            "tables": paged["cross_tables"], "len": src}


def cross_attention(params, x, kv: dict, cfg, decode: bool = False,
                    train: bool = False) -> torch.Tensor:
    """x (B,T,D) attends to precomputed source K/V (the reference's
    ``cross_attention``): queries without rotary, no mask, every source
    slot.  ``kv`` is dense {"k","v"} (B, S, KV, hd) or a
    :func:`paged_cross_view`.  ``decode`` (T = 1, a decode step) reads
    them with the decode kernels at pos ``S - 1``; otherwise the flash
    kernel's cross form runs (a dense ``kv`` as B blocks of S slots;
    ``train``: through :class:`CrossAttentionFn`, dense ``kv`` only).
    Returns (B,T,D)."""
    q = _proj_q(params, x, cfg)                # no rotary across modalities
    b = x.shape[0]
    k, v = kv["k"], kv["v"]
    tables = kv.get("tables")
    n = k.shape[1] if tables is None else kv["len"]
    if decode:
        if tables is None:
            o = _attend(lambda q, k, v: dense_decode_attention(
                q, k, v, _rows_at(q.shape[0], n - 1, q.device)),
                q[:, 0], k, v, 1, 2)
        else:
            o = paged_decode_attention(q[:, 0], k, v, tables,
                                       _rows_at(b, n - 1, x.device))
        return _out(params, o[:, None], cfg)
    if train:
        if tables is not None:
            raise ValueError("cross_attention: train mode reads dense K/V")
        return _out(params, _attend(CrossAttentionFn.apply, q, k, v, 2, 2),
                    cfg)
    if tables is None:
        return _out(params, _attend(lambda q, k, v: paged_cross_attention(
            q, k, v, _identity_tables(q.shape[0], q.device), n),
            q, k, v, 2, 2), cfg)
    return _out(params, paged_cross_attention(q, k, v, tables, n), cfg)


def _ring_chunk(params, x, cache: dict, table, pos, w: int, cfg):
    """The ring branch of a one-request chunk (the swa branch of the
    reference's ``chunk_self_attention`` / ``paged_chunk_self_attention``):
    attend over ``[old ring ; chunk]``, then write the chunk's last
    ``keep = min(C, w)`` keys at ring slots ``positions[-keep:] % w``
    (only those: an earlier key would be overwritten within the chunk, and
    the slice has no duplicate scatter indices).  ``cache`` holds pools
    ``(NB, bs, KV, hd)`` read through ``table`` (nb,); a dense ring row is
    one block of W slots with table ``[0]``."""
    b, c, _ = x.shape
    if torch.is_tensor(pos):
        raise NotImplementedError(
            "a batched chunk (B rows at device positions) over a "
            "sliding-window ring: speculation is gated off for such models")
    if b != 1:
        raise ValueError(f"ring chunk attention prefills one request, got "
                         f"a batch of {b}")
    k_pool, v_pool = cache["k"], cache["v"]
    bs = k_pool.shape[1]
    pos = int(pos)
    positions = pos + torch.arange(c, device=x.device)
    q, k_new, v_new = _qkv(params, x, positions[None, :], cfg)
    o = ring_chunk_attention(q[0], k_pool, v_pool, table, k_new[0],
                             v_new[0], pos, w)
    keep = min(c, w)
    slots = positions[-keep:] % w
    phys = table[slots // bs].long()
    off = slots % bs
    k_pool[phys, off] = k_new[0, -keep:]
    v_pool[phys, off] = v_new[0, -keep:]
    return _out(params, o[None], cfg), cache


def paged_decode_self_attention(params, x, cache: dict, paged: dict, pos,
                                cfg, kind: str) -> Tuple[torch.Tensor, dict]:
    """One-token decode against paged block pools.

    x: (B,1,D); cache {"k","v"}: (NB_phys, bs, KV, hd) pools of one
    layer, updated in place; paged["tables"] (B, nb) int32 (and, for a
    ring layer, paged["swa_tables"] (B, nb_swa)); pos (B,) int32
    absolute position of the new token.  Returns (out (B,1,D), cache).
    """
    ring = _is_ring(kind, cfg)
    b = x.shape[0]
    k_pool, v_pool = cache["k"], cache["v"]
    bs = k_pool.shape[1]
    max_len = paged["tables"].shape[1] * bs
    q, k_new, v_new = _qkv(params, x, pos[:, None], cfg)

    if ring:
        tables = paged["swa_tables"]
        w = min(cfg.window, max_len)
        slot = torch.remainder(pos.long(), w)
    else:
        tables = paged["tables"]
        slot = torch.clamp(pos.long(), max=max_len - 1)
    bidx = torch.arange(b, device=x.device)
    phys = tables[bidx, slot // bs].long()
    off = slot % bs
    # rows of a decode batch own disjoint blocks; only inactive rows
    # share the scratch block (id 0), whose content is never read
    k_pool[phys, off] = k_new[:, 0]
    v_pool[phys, off] = v_new[:, 0]

    kpos = torch.clamp(pos, max=w - 1) if ring else pos
    o = paged_decode_attention(q[:, 0], k_pool, v_pool, tables, kpos)
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
    ``paged_chunk_self_attention``).  A ring layer takes the row's
    ``paged["swa_tables"]`` (1, nb_swa) and :func:`_ring_chunk`'s order
    instead.  Returns (out (B,C,D), cache).
    """
    b, c, _ = x.shape
    k_pool, v_pool = cache["k"], cache["v"]
    bs = k_pool.shape[1]
    tables = paged["tables"]
    max_len = tables.shape[1] * bs
    if _is_ring(kind, cfg):
        return _ring_chunk(params, x, cache, paged["swa_tables"][0], pos,
                           min(cfg.window, max_len), cfg)
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
    cache, or at ``pos % S`` in a ring (S = ``min(window, seq_len)``).
    Returns (out (B,1,D), cache).
    """
    ring = _is_ring(kind, cfg)
    b = x.shape[0]
    k_cache, v_cache = cache["k"], cache["v"]
    s = k_cache.shape[1]
    q, k_new, v_new = _qkv(params, x, pos[:, None], cfg)
    if is_dtensor(k_cache):
        return _out(params, _decode_sharded(q[:, 0], k_new[:, 0],
                                            v_new[:, 0], k_cache, v_cache,
                                            pos, ring)[:, None], cfg), cache
    slot = (torch.remainder(pos.long(), s) if ring
            else torch.clamp(pos.long(), max=s - 1))
    bidx = torch.arange(b, device=x.device)
    k_cache[bidx, slot] = k_new[:, 0]
    v_cache[bidx, slot] = v_new[:, 0]
    kpos = torch.clamp(pos, max=s - 1) if ring else pos
    o = dense_decode_attention(q[:, 0], k_cache, v_cache, kpos)
    return _out(params, o[:, None], cfg), cache


def _decode_sharded(q, k_new, v_new, k_cache, v_cache, pos, ring: bool):
    """:func:`decode_self_attention`'s write and read on each rank's
    slice of a DTensor cache (B, S, KV, hd), whose placements stay as
    they are (:func:`_head_placements` with the cache): q (B,H,hd),
    k_new / v_new (B,KV,hd) and pos (B,) follow its rows and KV heads.
    A cache sharded along its slots (the ``seq`` layout) takes the new
    K/V on the rank that holds the slot and combines the ranks' softmax
    partials (``serving/decode.py::distributed_decode_attention``).
    Returns (B,H,hd)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = k_cache.device_mesh
    n_heads, n_kv, s = q.shape[1], k_cache.shape[2], k_cache.shape[1]
    qp, kp, sliced, seq = _head_placements(q, n_kv, 1, 2, cache=k_cache)
    newp = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else
            Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in kp]
    posp = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in kp]

    def run(q, k_new, v_new, kc, vc, pos):
        s_loc = kc.shape[1]
        start = 0 if seq is None else mesh.get_local_rank(seq) * s_loc
        slot = (torch.remainder(pos.long(), s) if ring
                else torch.clamp(pos.long(), max=s - 1)) - start
        bidx = torch.arange(q.shape[0], device=q.device)
        mine = ((slot >= 0) & (slot < s_loc))[:, None, None]
        slot = torch.clamp(slot, 0, s_loc - 1)
        for c, new in ((kc, k_new), (vc, v_new)):
            c[bidx, slot] = torch.where(mine, new, c[bidx, slot])
        kpos = torch.clamp(pos, max=s - 1) if ring else pos
        kc, vc = _narrow_kv(mesh, sliced, n_heads, n_kv, 2, kc, vc)
        if seq is None:
            return dense_decode_attention(q, kc, vc, kpos)
        from repro_torch.serving.decode import distributed_decode_attention
        return distributed_decode_attention(
            q, kc, vc, kpos, mesh, axis=mesh.mesh_dim_names[seq])
    return local_call(run, (q, k_new, v_new, k_cache, v_cache, pos),
                      (qp, newp, newp, kp, kp, posp), qp)


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
    S slots).  A ring layer's row (S = ``min(window, seq_len)`` slots) is
    one block of S slots with table ``[0]`` for :func:`_ring_chunk`.
    Returns (out (B,C,D), cache).
    """
    b, c, _ = x.shape
    k_cache, v_cache = cache["k"], cache["v"]
    if _is_ring(kind, cfg):
        table = torch.zeros(1, dtype=torch.int32, device=x.device)
        return _ring_chunk(params, x, cache, table, pos, k_cache.shape[1],
                           cfg)
    if torch.is_tensor(pos):
        # duplicate scatter indices only at a row's clamped last slot,
        # never read below its accepted length
        positions = pos.long()[:, None] + torch.arange(c, device=x.device)
        q, k_new, v_new = _qkv(params, x, positions, cfg)
        slots = torch.clamp(positions, max=k_cache.shape[1] - 1)
        bidx = torch.arange(b, device=x.device)[:, None]
        k_cache[bidx, slots] = k_new
        v_cache[bidx, slots] = v_new
        o = paged_chunk_attention(q, k_cache, v_cache,
                                  _identity_tables(b, x.device), pos)
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
