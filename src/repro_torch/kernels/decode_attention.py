"""Flash-decode, paged and dense: the CUDA kernels' wrappers and their
plain versions.

Ports of the two kernels of ``repro/kernels/decode_attention.py`` as the
reference model runs them, one query token per row, GQA, slots masked
above ``pos``:

* ``paged_decode_attention_pallas`` -> :func:`paged_decode_attention`,
  against the model's paged pools ``(NB, bs, KV, hd)`` of one layer,
  reached through block tables ``(B, nb)``
  (``csrc/paged_decode_attention.cu``);
* ``decode_attention_pallas`` -> :func:`dense_decode_attention`, against
  the slot engines' dense caches ``(B, S, KV, hd)`` of one layer, read
  in place (``csrc/dense_decode_attention.cu``);
* the same kernel's partials form, :func:`dense_decode_attention_partial`:
  one rank's slice of a sequence-sharded dense cache, slot j being
  logical slot ``s_start + j``, returning the f32 softmax partials
  ``(acc, m, l)`` of ``repro/serving/decode.py::_local_flash_decode``,
  which ``serving/decode.py`` combines across the ranks.

Both kernels share their bodies (``csrc/decode_attention.cuh``), named
by one rule, :func:`decode_body`, so on the card a dense row and a paged
row with the same KV give the same bits:

* ``"mma"`` (bfloat16, 16-byte aligned tensors, and ``hd % 16 == 0``,
  ``hd <= 128`` with at most 16 query heads per KV head, or ``hd ==
  256`` with at most 8; every bf16 launch the served models make): each
  (row, KV head) is a thread-block cluster of :func:`decode_splits` CTAs
  that cut the row's live slot range by logical slot (reading ``pos``
  on the device), compute both products on the tensor cores in f32
  arithmetic, and merge their softmax partials in split order through
  distributed shared memory.  Up to hd 128 the G heads sit on the m16
  side of ``mma.sync`` m16n8k16.  At hd 256 (gemma3-12b) the layout is
  transposed: 16 slots on m16 and the heads on n8, ``S^T = K Q^T`` and
  ``O^T = V^T P^T``, so a warp holds 16 dims x 8 heads per output
  fragment, 64 f32 registers of O and 32 of Q instead of 128 and 64;
  each lane's P^T half-tiles reach the B layout through ``movmatrix``.
  A CTA keeps 3 ring stages of 64 slots (202,752 B at hd 256: one CTA
  an SM).  Bound at gemma3's decode: bytes (2 x 8 KV heads x up to 2,176
  slots x 512 B a row).
* ``"cuda_core"`` (float32 at every shape, bfloat16 at the others): one
  block per (row, KV head) on the f32 CUDA cores.  float32 stays there
  because the card's f32 streams must equal the CPU's.

The wrappers run the plain version for CPU tensors only; for CUDA
tensors they launch the body the rule names, or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, fake

NEG_INF = -1e30
SM_COUNT = 132            # H100 SXM
SMEM_PER_BLOCK = 232448   # dynamic shared memory a block may use (227 KB)
DECODE_CHUNK = 16         # csrc/decode_attention.cuh: kSplitChunk
DECODE_WARPS = 4          # kSplitWarps
DECODE_STAGES = 3         # kSplitStages
DECODE_MAX_SPLITS = 8     # kMaxDecodeSplits, a portable cluster
DECODE_MAX_HEADS = 16     # kMaxSplitHeads: G on the m16 side (hd <= 128)
DECODE_WIDE_HD = 256      # the wide layout's head dim
DECODE_WIDE_MAX_HEADS = 8  # kMaxSplitHeadsWide: G on the n8 side


def decode_body(dtype: torch.dtype, hd: int, g: int,
                aligned: bool = True) -> str:
    """The decode kernel body a launch takes (paged and dense alike):
    ``"mma"`` for bfloat16 with 16-byte aligned tensors and either a
    head dim of whole k16 steps up to 128 with at most 16 query heads
    per KV head, or head dim 256 with at most 8; else ``"cuda_core"``."""
    if dtype != torch.bfloat16 or not aligned:
        return "cuda_core"
    if hd % 16 == 0 and 16 <= hd <= 128 and g <= DECODE_MAX_HEADS:
        return "mma"
    if hd == DECODE_WIDE_HD and g <= DECODE_WIDE_MAX_HEADS:
        return "mma"
    return "cuda_core"


def decode_smem_bytes(hd: int, g: int) -> int:
    """Dynamic shared memory of the mma body (``split_smem_bytes``): the
    K/V ring of DECODE_STAGES steps of DECODE_WARPS * DECODE_CHUNK slot
    rows padded to hd + 8 bf16, reused for the warps' and the CTA's f32
    partials of g heads."""
    ring = DECODE_STAGES * 2 * DECODE_WARPS * DECODE_CHUNK * (hd + 8) * 2
    parts = (DECODE_WARPS + 1) * g * (hd + 2) * 4
    return max(ring, parts)


#: clusters of each size (1 to 8) the H100 SXM holds at once when shared
#: memory allows one CTA an SM, as it does for the wide (hd 256) bodies:
#: the SMs of a GPC take whole clusters only
#: (``cudaOccupancyMaxActiveClusters`` at both wide bodies' shared memory,
#: printed by ``tools/torch_split_sweep.py`` on an H100 80GB HBM3)
WIDE_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


def wide_splits(pairs: int, steps: int) -> int:
    """CTAs a cluster of a wide body takes for each of ``pairs`` units of
    work (row tiles or rows, times KV heads): the most, up to a portable
    cluster of 8 and to ``steps`` (the units' slot steps at capacity),
    whose clusters the card holds all at once (``WIDE_CLUSTERS``); 1
    when even single CTAs take more than one wave."""
    fits = [s for s in range(1, min(DECODE_MAX_SPLITS, steps) + 1)
            if pairs <= WIDE_CLUSTERS[s]]
    return max(fits, default=1)


def decode_splits(b: int, kv: int, capacity: int, hd: int) -> int:
    """CTAs per (row, KV head) for the mma body (``capacity`` = nb * bs
    paged, S dense).  Up to hd 128: about two CTAs per SM over the
    ``b * kv`` pairs, at most one portable cluster of 8 and no more than
    the capacity's 16-slot chunks.  At hd 256 (one CTA an SM):
    :func:`wide_splits`.  Shapes only: the slots each CTA takes are cut
    from ``pos`` on the device, so the host never reads it, and the same
    shapes give the same split and so the same bits."""
    chunks = -(-capacity // DECODE_CHUNK)
    if hd > 128:
        return wide_splits(b * kv, chunks)
    want = -(-2 * SM_COUNT // max(1, b * kv))
    return max(1, min(DECODE_MAX_SPLITS, want, chunks))


def _body_and_splits(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     out: torch.Tensor, kv: int, capacity: int,
                     body: Optional[str]) -> tuple:
    b, h, hd = q.shape
    body = body or decode_body(
        q.dtype, hd, h // kv,
        all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    return body, decode_splits(b, kv, capacity, hd) if body == "mma" else 1


def paged_gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pool (NB, bs, KV, hd) gathered through tables (B, nb) into the
    logical view (B, nb*bs, KV, hd) (``attention.py::_paged_gather``)."""
    g = pool[tables.long()]
    b, nb, bs = g.shape[:3]
    return g.reshape(b, nb * bs, *g.shape[3:])


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, tables: torch.Tensor,
                                 pos: torch.Tensor,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """Gather + f32 scores + mask + softmax, as
    ``repro/models/attention.py::paged_decode_self_attention`` computes
    them.  q (B,H,hd); pools (NB,bs,KV,hd); tables (B,nb); pos (B,).
    Returns (B,H,hd) in q.dtype."""
    b, h, hd = q.shape
    kv = k_pool.shape[2]
    g = h // kv
    scale = hd ** -0.5 if scale is None else scale
    kg = paged_gather(k_pool, tables).float()
    vg = paged_gather(v_pool, tables).float()
    s = kg.shape[1]
    qg = q.reshape(b, kv, g, hd).float()
    scores = torch.einsum("bngh,bsnh->bngs", qg, kg) * scale
    kpos = torch.arange(s, device=q.device)
    valid = kpos[None, :] <= pos.long()[:, None]                  # (B,S)
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    probs = torch.softmax(scores + mask[:, None, None, :], dim=-1)
    out = torch.einsum("bngs,bsnh->bngh", probs, vg)
    return out.reshape(b, h, hd).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor, scale: Optional[float] = None,
                           _body: Optional[str] = None) -> torch.Tensor:
    """Paged decode attention; see :func:`paged_decode_attention_plain`
    for the contract.  Pools are read in place, never transposed.
    ``_body`` forces a kernel body over :func:`decode_body`'s choice, for
    timing the bodies against each other; the model never passes it."""
    if fake.is_abstract(q):
        return fake.paged_decode(q, k_pool, v_pool, tables)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, tables, pos,
                                            scale)
    b, h, hd = q.shape
    nbp, bs, kv, hd_k = k_pool.shape
    nb = tables.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    tensors = (q, k_pool, v_pool, tables, pos)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode_attention: all tensors must lie on "
                         "one CUDA device")
    if (hd_k != hd or v_pool.shape != k_pool.shape or h % kv
            or tables.shape != (b, nb) or pos.shape != (b,)):
        raise ValueError(
            f"paged_decode_attention: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, tables "
            f"{tuple(tables.shape)}, pos {tuple(pos.shape)} do not fit")
    if (k_pool.dtype != q.dtype or v_pool.dtype != q.dtype
            or tables.dtype != torch.int32 or pos.dtype != torch.int32):
        raise TypeError("paged_decode_attention: q and pools must share a "
                        "dtype; tables and pos must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention: the kernel takes "
                         "contiguous tensors")
    out = torch.empty_like(q)
    body, splits = _body_and_splits(q, k_pool, v_pool, out, kv, nb * bs,
                                    _body)
    lib = _build.library()
    _build.launches["paged_decode_attention"] += 1
    _build.bodies["paged_decode_attention"][body] += 1
    _build.check(lib.rt_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, h, kv, hd, bs, nb, float(scale), _build.dtype_code(q.dtype),
        _build.BODY_CODES[body], splits,
        torch.cuda.current_stream(q.device).cuda_stream),
        "paged_decode_attention")
    return out


def dense_decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, pos: torch.Tensor,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """f32 scores + mask + softmax over dense caches, as
    ``repro/models/attention.py::decode_self_attention`` computes them
    (linear cache: slot s is valid for s <= pos).  q (B,H,hd); caches
    (B,S,KV,hd); pos (B,).  Returns (B,H,hd) in q.dtype."""
    b, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(b, kv, g, hd).float()
    scores = torch.einsum("bngh,bsnh->bngs", qg, k_cache.float()) * scale
    kpos = torch.arange(s, device=q.device)
    valid = kpos[None, :] <= pos.long()[:, None]                  # (B,S)
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    probs = torch.softmax(scores + mask[:, None, None, :], dim=-1)
    out = torch.einsum("bngs,bsnh->bngh", probs, v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def dense_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor,
                           scale: Optional[float] = None,
                           _body: Optional[str] = None) -> torch.Tensor:
    """Dense decode attention; see :func:`dense_decode_attention_plain`
    for the contract.  Caches are read in place, never transposed.
    ``_body`` as for :func:`paged_decode_attention`."""
    if fake.is_abstract(q):
        return fake.dense_decode(q, k_cache, v_cache)
    if q.device.type == "cpu":
        return dense_decode_attention_plain(q, k_cache, v_cache, pos, scale)
    b, h, hd = q.shape
    bc, s, kv, hd_k = k_cache.shape
    scale = hd ** -0.5 if scale is None else scale
    tensors = (q, k_cache, v_cache, pos)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("dense_decode_attention: all tensors must lie on "
                         "one CUDA device")
    if (hd_k != hd or bc != b or v_cache.shape != k_cache.shape or h % kv
            or pos.shape != (b,)):
        raise ValueError(
            f"dense_decode_attention: shapes q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, pos "
            f"{tuple(pos.shape)} do not fit")
    if (k_cache.dtype != q.dtype or v_cache.dtype != q.dtype
            or pos.dtype != torch.int32):
        raise TypeError("dense_decode_attention: q and caches must share a "
                        "dtype; pos must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dense_decode_attention: the kernel takes "
                         "contiguous tensors")
    out = torch.empty_like(q)
    body, splits = _body_and_splits(q, k_cache, v_cache, out, kv, s, _body)
    lib = _build.library()
    _build.launches["dense_decode_attention"] += 1
    _build.bodies["dense_decode_attention"][body] += 1
    _build.check(lib.rt_dense_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, h, kv, hd, s, float(scale),
        _build.dtype_code(q.dtype), _build.BODY_CODES[body], splits,
        torch.cuda.current_stream(q.device).cuda_stream),
        "dense_decode_attention")
    return out


def dense_decode_attention_partial_plain(q: torch.Tensor,
                                         k_cache: torch.Tensor,
                                         v_cache: torch.Tensor,
                                         pos: torch.Tensor, s_start: int,
                                         scale: Optional[float] = None
                                         ) -> tuple:
    """``_local_flash_decode`` of ``repro/serving/decode.py`` over the
    port's dense layout: q (B,H,hd); the rank's cache slice (B,S_loc,KV,
    hd), slot j being logical slot ``s_start + j``, valid for ``s_start +
    j <= pos``; pos (B,).  Returns float32 ``acc`` (B,H,hd), unnormalised,
    and ``m``, ``l`` (B,H,1): a row with no valid slot has m = NEG_INF,
    l = 0, acc = 0."""
    b, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(b, kv, g, hd).float()
    scores = torch.einsum("bngh,bsnh->bngs", qg, k_cache.float()) * scale
    kpos = s_start + torch.arange(s, device=q.device)
    valid = (kpos[None, :] <= pos.long()[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)                        # (B,KV,G,1)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngs,bsnh->bngh", p, v_cache.float())
    return acc.reshape(b, h, hd), m.reshape(b, h, 1), l.reshape(b, h, 1)


def dense_decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                                   v_cache: torch.Tensor, pos: torch.Tensor,
                                   s_start: int,
                                   scale: Optional[float] = None,
                                   _body: Optional[str] = None) -> tuple:
    """The partials form of :func:`dense_decode_attention`; see
    :func:`dense_decode_attention_partial_plain` for the contract.  The
    kernel reads ``pos`` on the device and cuts each row's last slot at
    ``pos - s_start``; the body and split count are the dense kernel's
    (:func:`decode_body`, :func:`decode_splits` over the slice's
    ``S_loc``).  ``_body`` as for :func:`paged_decode_attention`."""
    if fake.is_abstract(q):
        return fake.dense_decode_partial(q, k_cache, v_cache)
    if q.device.type == "cpu":
        return dense_decode_attention_partial_plain(q, k_cache, v_cache, pos,
                                                    s_start, scale)
    b, h, hd = q.shape
    bc, s, kv, hd_k = k_cache.shape
    scale = hd ** -0.5 if scale is None else scale
    tensors = (q, k_cache, v_cache, pos)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("dense_decode_attention_partial: all tensors must "
                         "lie on one CUDA device")
    if (hd_k != hd or bc != b or v_cache.shape != k_cache.shape or h % kv
            or pos.shape != (b,) or s_start < 0):
        raise ValueError(
            f"dense_decode_attention_partial: shapes q {tuple(q.shape)}, "
            f"caches {tuple(k_cache.shape)}/{tuple(v_cache.shape)}, pos "
            f"{tuple(pos.shape)}, s_start {s_start} do not fit")
    if (k_cache.dtype != q.dtype or v_cache.dtype != q.dtype
            or pos.dtype != torch.int32):
        raise TypeError("dense_decode_attention_partial: q and caches must "
                        "share a dtype; pos must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dense_decode_attention_partial: the kernel takes "
                         "contiguous tensors")
    acc = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, 1), dtype=torch.float32, device=q.device)
    body, splits = _body_and_splits(q, k_cache, v_cache, acc, kv, s, _body)
    lib = _build.library()
    _build.launches["dense_decode_attention_partial"] += 1
    _build.bodies["dense_decode_attention_partial"][body] += 1
    _build.check(lib.rt_dense_decode_attention_partial(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, kv, hd, s,
        int(s_start), float(scale), _build.dtype_code(q.dtype),
        _build.BODY_CODES[body], splits,
        torch.cuda.current_stream(q.device).cuda_stream),
        "dense_decode_attention_partial")
    return acc, m, l
