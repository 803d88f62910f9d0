"""Paged causal prefill attention: the CUDA kernel's wrapper and its
plain version.

Port of ``repro/kernels/flash_attention.py::flash_attention_pallas`` in
the form the reference model's chunked prefill runs it (the linear
branch of ``repro/models/attention.py::paged_chunk_self_attention``):
C query tokens of one request, at positions ``pos .. pos + C - 1``,
attend causally to the logical slots ``[0, pos + C)`` of the model's
paged pools ``(NB, bs, KV, hd)`` through the request's block table.
With ``pos = 0`` and an identity table this is causal flash attention
over contiguous K/V.  The kernel is ``csrc/paged_prefill_attention.cu``;
the TPU kernel it replaces is ``src/repro/kernels/flash_attention.py:72``.

Bound on the H100: bytes at the main path's chunks (C = 128 against a
prefix of a few hundred keys; at gemma3's hd 256, 1,152-2,176 keys of 8
KV heads), and in practice latency and SM fill.
The kernel has two bodies, named by :func:`prefill_body`:

* ``"mma"`` (bfloat16, ``hd % 16 == 0`` up to 128 or ``hd == 256``,
  16-byte aligned tensors; every bf16 launch the served models make):
  Q K^T and P V on the tensor cores (``mma.sync`` m16n8k16, f32
  accumulators), one CTA per KV head and 64 (query, head) rows, so the
  G heads of a group share each K/V tile; P enters the PV product as
  two bf16 parts (``P_hi + P_lo``, about 16 bits), so the output stays
  within one final bf16 rounding of the f32 plain version.  At hd 256
  (gemma3-12b's ``attn`` layers) the body is wide: key tiles of 32
  slots a key group, Q read from shared memory at each k16 step rather
  than held (64 rows x 264 + 2 x 2 x 64 slots x 264 bf16 = 168,960 B,
  one CTA an SM; 128 f32 registers of O a thread), and each row tile's
  key range split across a cluster of :func:`prefill_splits` CTAs (3 at
  gemma3's chunk: 4 tiles x 8 KV heads x 3 = 96 CTAs, the most whose
  clusters the card holds at once) by logical slot, merged in split
  order through distributed shared memory.
* ``"cuda_core"`` (float32 at every shape, bfloat16 at the others):
  the f32 CUDA-core body.  float32 stays there because the card's f32
  streams must equal the CPU's, and TF32 tensor cores would round the
  inputs.

The batched form :func:`paged_chunk_attention` runs the same kernel over
B rows of C tokens, each row at its own ``pos[b]``, which it reads from a
``(B,)`` int32 tensor on the device: it is the linear branch of the
reference's ``paged_chunk_self_attention`` for B rows, the form
``Model.verify_steps`` runs (B rows of K + 1 tokens a draft-verify
round).  The host never reads ``pos``, and the grid depends on B, C, H
and KV only.  Row b's output is bit-equal to a one-row call at
``pos[b]``, since the kernel runs the same instructions for it.

The windowed form :func:`ring_chunk_attention` (``window > 0`` in the
TPU kernel) is the swa branch of the reference's chunk attention: C
queries of one request attend to the w keys of its sliding-window ring
(read in place through the ring's block table) followed by the chunk's
own C keys, under the causal and the window mask
(``csrc/ring_chunk_attention.cu``).  Its ``pos`` is a host int or a
``(1,)`` int32 tensor on the device, which the CTAs read themselves: the
grid depends on C, H, KV, hd and w only.  Two bodies, named by
:func:`ring_body` where :func:`prefill_body` names them: ``"mma"``, the
prefill's tensor-core tiles over the ring's key numbering (at hd 256
each row tile's steps split across a cluster of :func:`ring_splits`
CTAs), and ``"cuda_core"``, the f32 CUDA-core body (float32 at every
shape, bfloat16 at the others, hd up to 256).

The contiguous form :func:`flash_attention` is the TPU kernel's own
signature: Q ``(B, H, S, hd)`` over K / V ``(B, KV, S, hd)`` of the same
positions, causal or not, with a window (causal only), no cache; it
also returns the f32 row log-sum-exp ``(B, H, S)``.  The reference
model's train mode runs it (``self_attention``, through
:class:`FlashAttentionFn`, whose gradient :func:`flash_attention_backward`
recomputes P from that log-sum-exp in torch ops, in blocks of
:data:`FLASH_Q_BLOCK` queries).  The kernel (``csrc/flash_attention.cu``)
reads every tensor through its strides, so the model's ``(B, S, H, hd)``
projections go in as transposed views without a copy.  Two bodies,
named by :func:`prefill_body` (the strides count in ``aligned``):
``"mma"``, the same tensor-core tiles over contiguous keys, tiles above
the diagonal (and before the window) skipped, 64 (query, head) rows a
CTA, no split; and ``"cuda_core"``, the window form's f32 CUDA-core
body over contiguous keys.

The wrappers run the plain versions for CPU tensors only; for CUDA
tensors they launch the body the rule names, or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (NEG_INF, paged_gather,
                                                  wide_splits)


PREFILL_ROWS = 64         # csrc/paged_prefill_attention.cu: mma::kRows
PREFILL_WIDE_HD = 256     # the wide body's head dim


def prefill_body(dtype: torch.dtype, hd: int, aligned: bool = True) -> str:
    """The kernel body a launch takes: ``"mma"`` for bfloat16 with a head
    dim the tensor-core tiles take (whole k16 steps up to 128, or 256)
    and 16-byte aligned tensors, else ``"cuda_core"``."""
    if (dtype == torch.bfloat16 and aligned
            and (hd % 16 == 0 and hd <= 128 or hd == PREFILL_WIDE_HD)):
        return "mma"
    return "cuda_core"


def prefill_span(hd: int) -> int:
    """Logical slots a CTA of the mma body takes per step (``Tiles::kSpan``:
    two key groups of 64 slots up to hd 128, of 32 at 256)."""
    return 2 * (32 if hd > 128 else 64)


def prefill_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of the mma body (``mma::smem_bytes``): Q's
    PREFILL_ROWS rows and two K and two V buffers of a step's slots, rows
    padded to hd + 8 bf16."""
    return (PREFILL_ROWS + 4 * prefill_span(hd)) * (hd + 8) * 2


def ring_body(dtype: torch.dtype, hd: int, aligned: bool = True) -> str:
    """The window form's body: ``"mma"`` exactly where :func:`prefill_body`
    names it (bfloat16, 16-byte aligned q, pools, chunk K/V and out, hd of
    whole k16 steps up to 128 or 256), else ``"cuda_core"``, so float32
    keeps the card's streams equal to the CPU's."""
    return prefill_body(dtype, hd, aligned)


def ring_splits(c: int, h: int, kv: int, hd: int, w: int) -> int:
    """CTAs (one cluster) each row tile's steps of the window form's
    ``mma`` body are split across: 1 up to hd 128; at hd 256,
    :func:`wide_splits` over the row tiles x KV heads and the steps of a
    full ring plus a whole chunk.  Shapes only: the steps each CTA takes
    are cut from ``pos`` on the device (3 at gemma3's chunk: 32 units over
    16 + 2 steps)."""
    if hd <= 128:
        return 1
    span = prefill_span(hd)
    tiles = -(-c * (h // kv) // PREFILL_ROWS)
    return wide_splits(tiles * kv, -(-w // span) + -(-c // span))


def prefill_splits(c: int, h: int, kv: int, hd: int, capacity: int) -> int:
    """CTAs (one cluster) each row tile's key range is split across: 1 up
    to hd 128; at hd 256 (one CTA an SM), :func:`wide_splits` over the
    row tiles x KV heads of one row and the capacity's steps
    (``capacity`` = nb * bs).  Shapes only, and not the batch: the steps
    each CTA takes are cut from ``pos`` on the device, so a row of a
    batched launch gets the split of a one-row call and the same bits."""
    if hd <= 128:
        return 1
    tiles = -(-c * (h // kv) // PREFILL_ROWS)
    return wide_splits(tiles * kv, -(-capacity // prefill_span(hd)))


def paged_prefill_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor, table: torch.Tensor,
                                  pos: int,
                                  scale: Optional[float] = None) -> torch.Tensor:
    """Gather + f32 scores + causal mask + softmax, as the reference's
    paged chunk path computes them.  q (C,H,hd); pools (NB,bs,KV,hd);
    table (nb,); pos the absolute position of q's first token.
    Returns (C,H,hd) in q.dtype."""
    c, h, hd = q.shape
    kv = k_pool.shape[2]
    g = h // kv
    scale = hd ** -0.5 if scale is None else scale
    kg = paged_gather(k_pool, table[None])[0].float()
    vg = paged_gather(v_pool, table[None])[0].float()
    s = kg.shape[0]
    qg = q.reshape(c, kv, g, hd).float()
    scores = torch.einsum("qngh,snh->ngqs", qg, kg) * scale     # (KV,G,C,S)
    qpos = int(pos) + torch.arange(c, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.where(kpos <= qpos, 0.0, NEG_INF).to(torch.float32)
    probs = torch.softmax(scores + mask, dim=-1)
    out = torch.einsum("ngqs,snh->qngh", probs, vg)
    return out.reshape(c, h, hd).to(q.dtype)


def paged_chunk_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, tables: torch.Tensor,
                                pos: torch.Tensor,
                                scale: Optional[float] = None) -> torch.Tensor:
    """The batched form: gather + f32 scores + mask ``kpos <= qpos`` +
    softmax, as the linear branch of the reference's
    ``paged_chunk_self_attention`` computes them for B rows.  q
    (B,C,H,hd); pools (NB,bs,KV,hd); tables (B,nb); pos (B,) the absolute
    position of each row's first query.  Returns (B,C,H,hd) in q.dtype."""
    b, c, h, hd = q.shape
    kv = k_pool.shape[2]
    g = h // kv
    scale = hd ** -0.5 if scale is None else scale
    kg = paged_gather(k_pool, tables).float()
    vg = paged_gather(v_pool, tables).float()
    s = kg.shape[1]
    qg = q.reshape(b, c, kv, g, hd).float()
    scores = torch.einsum("bqngh,bsnh->bngqs", qg, kg) * scale  # (B,KV,G,C,S)
    qpos = (pos.long()[:, None, None]
            + torch.arange(c, device=q.device)[None, :, None])  # (B,C,1)
    kpos = torch.arange(s, device=q.device)[None, None, :]
    mask = torch.where(kpos <= qpos, 0.0, NEG_INF).to(torch.float32)
    probs = torch.softmax(scores + mask[:, None, None], dim=-1)
    out = torch.einsum("bngqs,bsnh->bqngh", probs, vg)
    return out.reshape(b, c, h, hd).to(q.dtype)


def paged_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, table: torch.Tensor,
                            pos: int, scale: Optional[float] = None,
                            _body: Optional[str] = None) -> torch.Tensor:
    """Paged causal prefill attention; see
    :func:`paged_prefill_attention_plain` for the contract.  ``_body``
    forces a kernel body over :func:`prefill_body`'s choice, for timing
    the bodies against each other; the model never passes it."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pool, v_pool, table, pos,
                                             scale)
    c, h, hd = q.shape
    nbp, bs, kv, hd_k = k_pool.shape
    nb = table.shape[0]
    pos = int(pos)
    scale = hd ** -0.5 if scale is None else scale
    tensors = (q, k_pool, v_pool, table)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("paged_prefill_attention: all tensors must lie on "
                         "one CUDA device")
    if (hd_k != hd or v_pool.shape != k_pool.shape or h % kv
            or table.dim() != 1 or pos < 0):
        raise ValueError(
            f"paged_prefill_attention: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
            f"{tuple(table.shape)}, pos {pos} do not fit")
    if (k_pool.dtype != q.dtype or v_pool.dtype != q.dtype
            or table.dtype != torch.int32):
        raise TypeError("paged_prefill_attention: q and pools must share a "
                        "dtype; the table must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_prefill_attention: the kernel takes "
                         "contiguous tensors")
    out = torch.empty_like(q)
    body = _body or prefill_body(
        q.dtype, hd, all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool)))
    splits = prefill_splits(c, h, kv, hd, nb * bs) if body == "mma" else 1
    lib = _build.library()
    _build.launches["paged_prefill_attention"] += 1
    _build.bodies["paged_prefill_attention"][body] += 1
    _build.check(lib.rt_paged_prefill_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        out.data_ptr(), c, h, kv, hd, bs, nb, pos, float(scale),
        _build.dtype_code(q.dtype), _build.BODY_CODES[body], splits,
        torch.cuda.current_stream(q.device).cuda_stream),
        "paged_prefill_attention")
    return out


def paged_chunk_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          pos: torch.Tensor, scale: Optional[float] = None,
                          _body: Optional[str] = None) -> torch.Tensor:
    """Batched paged causal chunk attention, each row's ``pos`` read on
    the device; see :func:`paged_chunk_attention_plain` for the contract
    and :func:`paged_prefill_attention` for ``_body``."""
    if q.device.type == "cpu":
        return paged_chunk_attention_plain(q, k_pool, v_pool, tables, pos,
                                           scale)
    b, c, h, hd = q.shape
    nbp, bs, kv, hd_k = k_pool.shape
    nb = tables.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    tensors = (q, k_pool, v_pool, tables, pos)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("paged_chunk_attention: all tensors must lie on one "
                         "CUDA device")
    if (hd_k != hd or v_pool.shape != k_pool.shape or h % kv
            or tables.shape != (b, nb) or pos.shape != (b,) or b > 65535):
        raise ValueError(
            f"paged_chunk_attention: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, tables "
            f"{tuple(tables.shape)}, pos {tuple(pos.shape)} do not fit")
    if (k_pool.dtype != q.dtype or v_pool.dtype != q.dtype
            or tables.dtype != torch.int32 or pos.dtype != torch.int32):
        raise TypeError("paged_chunk_attention: q and pools must share a "
                        "dtype; tables and pos must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_chunk_attention: the kernel takes contiguous "
                         "tensors")
    out = torch.empty_like(q)
    body = _body or prefill_body(
        q.dtype, hd, all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool)))
    splits = prefill_splits(c, h, kv, hd, nb * bs) if body == "mma" else 1
    lib = _build.library()
    _build.launches["paged_chunk_attention"] += 1
    _build.bodies["paged_chunk_attention"][body] += 1
    _build.check(lib.rt_paged_chunk_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(), b, c, h, kv, hd,
        bs, nb, float(scale), _build.dtype_code(q.dtype),
        _build.BODY_CODES[body], splits,
        torch.cuda.current_stream(q.device).cuda_stream),
        "paged_chunk_attention")
    return out


def ring_positions(pos: int, w: int, c: int, device) -> torch.Tensor:
    """Positions of the keys ``[old ring ; chunk]`` of a chunk at ``pos``
    over a ring of ``w`` slots: ring slot j holds the latest position
    p < pos with p % w == j, ``pos - w + ((j - pos) mod w)`` (negative
    where nothing was written yet); chunk key i sits at ``pos + i``."""
    j = torch.arange(w, device=device)
    p_old = pos - w + torch.remainder(j - pos, w)
    return torch.cat([p_old, pos + torch.arange(c, device=device)])


def ring_chunk_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, table: torch.Tensor,
                               k_new: torch.Tensor, v_new: torch.Tensor,
                               pos, w: int,
                               scale: Optional[float] = None) -> torch.Tensor:
    """The swa branch of the reference's ``paged_chunk_self_attention``,
    in its order: gather the ring's first ``w`` slots through ``table``,
    concatenate ``[ring ; chunk]``, f32 scores, the mask ``kpos >= 0 &
    kpos <= qpos & kpos > qpos - w``, softmax, P V.  q (C,H,hd); pools
    (NB,bs,KV,hd); table (nb,) with nb * bs >= w; k_new / v_new
    (C,KV,hd), the chunk's keys and values (not yet in the ring); pos the
    absolute position of q's first token, an int or a ``(1,)`` tensor
    (whose value is read here); w the ring size, ``min(window,
    max_len)``.  Returns (C,H,hd) in q.dtype."""
    c, h, hd = q.shape
    kv = k_pool.shape[2]
    g = h // kv
    pos = int(pos.item()) if torch.is_tensor(pos) else int(pos)
    scale = hd ** -0.5 if scale is None else scale
    k_all = torch.cat([paged_gather(k_pool, table[None])[0, :w], k_new]).float()
    v_all = torch.cat([paged_gather(v_pool, table[None])[0, :w], v_new]).float()
    qg = q.reshape(c, kv, g, hd).float()
    scores = torch.einsum("qngh,snh->ngqs", qg, k_all) * scale  # (KV,G,C,W+C)
    kpos = ring_positions(pos, w, c, q.device)[None, :]
    qpos = pos + torch.arange(c, device=q.device)[:, None]
    valid = (kpos >= 0) & (kpos <= qpos) & (kpos > qpos - w)
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    probs = torch.softmax(scores + mask, dim=-1)
    out = torch.einsum("ngqs,snh->qngh", probs, v_all)
    return out.reshape(c, h, hd).to(q.dtype)


def ring_chunk_attention(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, table: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor, pos,
                         w: int, scale: Optional[float] = None,
                         _body: Optional[str] = None) -> torch.Tensor:
    """Sliding-window chunk attention over a ring; see
    :func:`ring_chunk_attention_plain` for the contract.  ``pos`` is a
    host int or a ``(1,)`` int32 tensor on q's device, which the kernel
    reads there (the host never does).  The ring is read in place and
    not written: the caller writes the chunk's keys into it afterwards.
    ``_body`` as in :func:`paged_prefill_attention`."""
    if q.device.type == "cpu":
        return ring_chunk_attention_plain(q, k_pool, v_pool, table, k_new,
                                          v_new, pos, w, scale)
    c, h, hd = q.shape
    nbp, bs, kv, hd_k = k_pool.shape
    nb = table.shape[0] if table.dim() == 1 else -1
    pos_dev = pos if torch.is_tensor(pos) else None
    pos = 0 if pos_dev is not None else int(pos)
    w = int(w)
    scale = hd ** -0.5 if scale is None else scale
    tensors = (q, k_pool, v_pool, table, k_new, v_new) + (
        (pos_dev,) if pos_dev is not None else ())
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("ring_chunk_attention: all tensors must lie on one "
                         "CUDA device")
    if (hd_k != hd or v_pool.shape != k_pool.shape or h % kv or nb < 0
            or k_new.shape != (c, kv, hd) or v_new.shape != k_new.shape
            or pos < 0 or w <= 0 or nb * bs < w or hd > 256
            or (pos_dev is not None and pos_dev.shape != (1,))):
        raise ValueError(
            f"ring_chunk_attention: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
            f"{tuple(table.shape)}, chunk K/V {tuple(k_new.shape)}/"
            f"{tuple(v_new.shape)}, pos "
            f"{tuple(pos_dev.shape) if pos_dev is not None else pos}, w {w} "
            f"do not fit")
    if (any(t.dtype != q.dtype for t in (k_pool, v_pool, k_new, v_new))
            or table.dtype != torch.int32
            or (pos_dev is not None and pos_dev.dtype != torch.int32)):
        raise TypeError("ring_chunk_attention: q, pools and chunk K/V must "
                        "share a dtype; the table and a tensor pos must be "
                        "int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ring_chunk_attention: the kernel takes contiguous "
                         "tensors")
    out = torch.empty_like(q)
    body = _body or ring_body(q.dtype, hd, all(
        t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool, k_new, v_new,
                                         out)))
    splits = ring_splits(c, h, kv, hd, w) if body == "mma" else 1
    lib = _build.library()
    _build.launches["ring_chunk_attention"] += 1
    _build.bodies["ring_chunk_attention"][body] += 1
    _build.check(lib.rt_ring_chunk_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(),
        pos_dev.data_ptr() if pos_dev is not None else None, out.data_ptr(),
        c, h, kv, hd, bs, nb, pos, w, float(scale),
        _build.dtype_code(q.dtype), _build.BODY_CODES[body], splits,
        torch.cuda.current_stream(q.device).cuda_stream),
        "ring_chunk_attention")
    return out


# ----------------------------------------------------------------------
# the contiguous form: the TPU kernel's own signature
# ----------------------------------------------------------------------
#: queries a block of the plain version and the gradient take at once
#: (the reference blocks its queries too, ``attention.py::Q_CHUNK``): at
#: smollm-360m's train shape (B 8, H 15, S 4096) a block's f32 scores
#: are 512 x 4096 x 120 x 4 bytes, about 1 GB
FLASH_Q_BLOCK = 512


def _block_keys(q0: int, q1: int, s: int, causal: bool, window: int):
    """The keys ``[k0, k1)`` queries ``q0 .. q1 - 1`` may see (the
    reference's ``self_attention`` slices its blocks the same way)."""
    if not causal:
        return 0, s
    return (max(0, q0 - window + 1) if window > 0 else 0), q1


def _block_scores(q, k, q0, q1, k0, k1, causal, window, scale):
    """f32 scores ``(B, KV, G, q1 - q0, k1 - k0)`` of queries ``q0 ..
    q1 - 1`` against keys ``k0 .. k1 - 1``, masked at NEG_INF."""
    b, h, _, d = q.shape
    kv = k.shape[1]
    qb = q[:, :, q0:q1].float().reshape(b, kv, h // kv, q1 - q0, d)
    sc = torch.einsum("bngqd,bnkd->bngqk", qb, k[:, :, k0:k1].float()) * scale
    if causal:
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        ok = kpos <= qpos
        if window > 0:
            ok = ok & (kpos > qpos - window)
        sc = sc.masked_fill(~ok, NEG_INF)
    return sc


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None):
    """What ``flash_attention_pallas`` computes, in f32, in blocks of
    :data:`FLASH_Q_BLOCK` queries: scores ``scale * Q K^T`` (scale
    ``D ** -0.5`` by default), masked at NEG_INF where ``kpos > qpos``
    and, with ``window > 0``, ``kpos <= qpos - window`` (both only when
    causal: a non-causal call ignores the window), then ``exp(s - m) V``
    over the row sum, clamped at 1e-30.  q (B,H,S,D); k / v (B,KV,S,D),
    head h reading KV head ``h // (H // KV)``.  Returns (out, like q in
    q.dtype, and the f32 row log-sum-exp ``m + log(l)``, (B,H,S))."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, FLASH_Q_BLOCK):
        q1 = min(q0 + FLASH_Q_BLOCK, s)
        k0, k1 = _block_keys(q0, q1, s, causal, window)
        sc = _block_scores(q, k, q0, q1, k0, k1, causal, window, scale)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        l_sum = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
        ob = torch.einsum("bngqk,bnkd->bngqd", p, v[:, :, k0:k1].float())
        out[:, :, q0:q1] = (ob / l_sum).reshape(b, h, q1 - q0, d).to(q.dtype)
        lse[:, :, q0:q1] = (m + torch.log(l_sum)).reshape(b, h, q1 - q0)
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    _body: Optional[str] = None):
    """Contiguous flash attention; see :func:`flash_attention_plain` for
    the contract.  On the card every tensor is read in place through its
    strides (each head dim contiguous; K and V with equal strides), and
    out takes q's layout.  ``_body`` as in
    :func:`paged_prefill_attention`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    b, h, s, hd = q.shape
    kv = k.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: all tensors must lie on one CUDA "
                         "device")
    if (k.dim() != 4 or k.shape != (b, kv, s, hd) or v.shape != k.shape
            or h % kv or window < 0):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, window "
                         f"{window} do not fit")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")
    if any(t.stride(3) != 1 for t in (q, k, v)) or k.stride() != v.stride():
        raise ValueError(f"flash_attention: the kernel reads a contiguous "
                         f"head dim and K, V of equal strides, not q "
                         f"{q.stride()}, k {k.stride()}, v {v.stride()}")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    pack = 16 // q.element_size()
    aligned = (all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))
               and all(st % pack == 0 for t in (q, k, out)
                       for st in t.stride()[:3]))
    body = _body or prefill_body(q.dtype, hd, aligned)
    lib = _build.library()
    _build.launches["flash_attention"] += 1
    _build.bodies["flash_attention"][body] += 1
    _build.check(lib.rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, kv, s, hd, *q.stride()[:3], *k.stride()[:3],
        *out.stride()[:3], int(bool(causal)), int(window), float(scale),
        _build.dtype_code(q.dtype), _build.BODY_CODES[body],
        torch.cuda.current_stream(q.device).cuda_stream), "flash_attention")
    return out, lse


def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: int = 0, scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of :func:`flash_attention` in torch ops,
    recomputed in f32 from the forward's row log-sum-exp, in blocks of
    :data:`FLASH_Q_BLOCK` queries over the keys each block may see:
    P = exp(s Q K^T - lse) under the forward's mask, dV = P^T dO,
    dP = dO V^T, D = rowsum(dO * O), dS = P (dP - D), dQ = s dS K and
    dK = s dS^T Q, dK and dV summed over the G heads of a group.  Each
    gradient in its input's dtype and layout."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    g = h // kv
    scale = d ** -0.5 if scale is None else scale
    dq = torch.empty_like(q, dtype=torch.float32)
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    for q0 in range(0, s, FLASH_Q_BLOCK):
        q1 = min(q0 + FLASH_Q_BLOCK, s)
        n = q1 - q0
        k0, k1 = _block_keys(q0, q1, s, causal, window)
        p = _block_scores(q, k, q0, q1, k0, k1, causal, window, scale)
        p = p.sub_(lse[:, :, q0:q1].reshape(b, kv, g, n, 1)).exp_()
        dob = dout[:, :, q0:q1].float().reshape(b, kv, g, n, d)
        dv[:, :, k0:k1] += torch.einsum("bngqk,bngqd->bnkd", p, dob)
        dp = torch.einsum("bngqd,bnkd->bngqk", dob, v[:, :, k0:k1].float())
        dd = (dob * out[:, :, q0:q1].float().reshape(b, kv, g, n, d)).sum(
            dim=-1, keepdim=True)
        ds = p.mul_(dp.sub_(dd))
        dq[:, :, q0:q1] = torch.einsum(
            "bngqk,bnkd->bngqd", ds, k[:, :, k0:k1].float()).reshape(
                b, h, n, d) * scale
        qb = q[:, :, q0:q1].float().reshape(b, kv, g, n, d)
        dk[:, :, k0:k1] += torch.einsum("bngqk,bngqd->bnkd", ds, qb) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the forward is the kernel
    on a CUDA tensor and the plain version on a CPU one (the wrapper's
    rule), and saves q, k, v, out and the row log-sum-exp; the backward
    is :func:`flash_attention_backward` (torch ops: the TPU package has
    no backward kernel either, ``jax.value_and_grad`` differentiates its
    jnp code), under the profiler label ``flash_attention_backward``.
    ``apply(q, k, v, causal, window, scale)`` returns out."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=0, scale=None):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        with torch.profiler.record_function("flash_attention_backward"):
            dq, dk, dv = flash_attention_backward(
                q, k, v, out, lse, dout, causal=causal, window=window,
                scale=scale)
        return dq, dk, dv, None, None, None
