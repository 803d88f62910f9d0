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
The kernel has three bodies, named by :func:`chunk_body` (whose base,
:func:`prefill_body`, names the last two):

* ``"wgmma"`` (bfloat16 at hd 64, 112 and 128, 16-byte aligned tensors,
  blocks that cut into 8-slot TMA segments; every bf16 launch of the
  served models but gemma3-12b's): the cross form's warp-specialised body
  (``csrc/chunk_wgmma.cu``) with a causal mask, 128 (query, head) rows a
  CTA on ``wgmma``, the pools read in place by TMA through the table, each
  (row tile, KV head)'s key tiles split across a cluster of
  :func:`chunk_splits` CTAs, cut from each row's pos on the device and
  merged in split order through distributed shared memory.
* ``"mma"`` (bfloat16, ``hd % 16 == 0`` up to 128 or ``hd == 256``,
  16-byte aligned tensors; gemma3-12b's hd 256, and ``_body="mma"``):
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

The cross form :func:`paged_cross_attention` computes cross-attention:
C queries of each of B rows attend to every one of the first ``n_keys``
slots of the row's blocks, with no causal mask (the reference computes
it in jnp, ``cross_attention``, over a source of image patches or
encoder frames).  A cross layer's chunk reads the paged engine's cross
pools through the row's ``cross_tables`` (B = 1), and ``Model.prefill``
the dense cross caches of B rows through identity tables (B blocks of
``n_keys`` slots).  Every CTA's key range is ``[0, n_keys)``; only the
last tile's tail past ``n_keys - 1`` is masked.  Its body is
:func:`cross_body`'s: ``"wgmma"`` (bf16 at hd 64 and 128,
``csrc/paged_cross_attention.cu``), the contiguous form's
warp-specialised body over the pools read in place by TMA, one box a
(block, tile) segment, the slots past ``n_keys - 1`` arriving as zeros,
each row tile's key tiles split across a cluster of :func:`cross_splits`
CTAs; else the paged-chunk form's ``"mma"`` or ``"cuda_core"`` body
with the key range set to ``[0, n_keys)``.

The windowed form :func:`ring_chunk_attention` (``window > 0`` in the
TPU kernel) is the swa branch of the reference's chunk attention: C
queries of one request attend to the w keys of its sliding-window ring
(read in place through the ring's block table) followed by the chunk's
own C keys, under the causal and the window mask
(``csrc/ring_chunk_attention.cu``).  Its ``pos`` is a host int or a
``(1,)`` int32 tensor on the device, which the CTAs read themselves: the
grid depends on C, H, KV, hd and w only.  Three bodies, named by
:func:`ring_body`: ``"wgmma"`` (bfloat16 at hd 64, 112 and 128), the
paged chunk's ``csrc/chunk_wgmma.cu`` body with the window mask, ring
tiles through the pool map and table and chunk tiles through a map over
the chunk's K/V, each (row tile, KV head)'s tiles split across a
cluster of :func:`ring_splits` CTAs; ``"mma"`` where
:func:`prefill_body` names it otherwise, the prefill's tensor-core
tiles over the ring's key numbering (at hd 256 each row tile's steps
split across a cluster of :func:`ring_splits` CTAs); and
``"cuda_core"``, the f32 CUDA-core body (float32 at every shape,
bfloat16 at the others, hd up to 256).

The contiguous form :func:`flash_attention` is the TPU kernel's own
signature: Q ``(B, H, S, hd)`` over K / V ``(B, KV, S, hd)`` of the same
positions, causal or not, with a window (causal only), no cache; it
also returns the f32 row log-sum-exp ``(B, H, S)``.  The reference
model's train mode runs it (``self_attention``, through
:class:`FlashAttentionFn`, whose gradient :func:`flash_attention_backward`
recomputes P from that log-sum-exp in torch ops, in blocks of
:data:`FLASH_Q_BLOCK` queries).  The kernel (``csrc/flash_attention.cu``)
reads every tensor through its strides, so the model's ``(B, S, H, hd)``
projections go in as transposed views without a copy.  Three bodies,
named by :func:`flash_body` (the strides count in ``aligned``):
``"wgmma"`` (bfloat16, hd 64, 112 and 128, 16-byte aligned: every launch
of smollm-360m's and zamba2-7b's train steps and of ``Model.prefill``'s
self-attention), a warp-specialised body for Hopper
(``csrc/wg_attention.cuh``): one producer warp loads Q once and K / V
tiles (128 keys at hd 64, 64 at hd 128, whose rows are two 128-byte
swizzled halves; hd 112 runs the hd-128 body, TMA filling columns 112-127
with zeros) into a ring
through TMA tensor maps over the tensors' own strides, and consumer
warpgroups of 64 (query, head-in-group) rows run S = Q K^T and
O += (P_hi + P_lo) V on ``wgmma`` (f32 accumulators), row tiles with the
most keys launched first; ``"mma"``, the paged prefill's tensor-core
tiles over contiguous keys (bf16 at the other head dims
:func:`prefill_body` takes), 64 rows a CTA; and ``"cuda_core"``, the
window form's f32 CUDA-core body over contiguous keys.  Tiles above the
diagonal (and before the window) are skipped on every body.

The wrappers run the plain versions for CPU tensors only; for CUDA
tensors they launch the body the rule names, or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, fake
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


#: the warp-specialised wgmma bodies (csrc/wg_attention.cuh): the head
#: dims the contiguous form's takes (csrc/flash_attention.cu; hd 112 on
#: the hd-128 body, its last 16 columns zero-filled by TMA), the head dims
#: the cross form's takes (csrc/paged_cross_attention.cu), those the paged
#: chunk's and the window form's take (csrc/chunk_wgmma.cu; hd 112 as the
#: contiguous form's), and the (query, head-in-group) rows a CTA holds
#: (two consumer warpgroups of 64)
WGMMA_HD = (64, 112, 128)
CROSS_WGMMA_HD = (64, 128)
CHUNK_WGMMA_HD = (64, 112, 128)
RING_WGMMA_HD = (64, 112, 128)
WGMMA_ROWS = 128


def wgmma_body_hd(hd: int) -> int:
    """The head dim of the wgmma body a launch at ``hd`` runs: whole
    64-column halves (112 runs the body of 128)."""
    return -(-hd // 64) * 64


def wgmma_tile_keys(hd: int, form: str = "flash") -> int:
    """Keys a K/V tile of a wgmma body holds (``wgt::Cfg::kTK``): the
    contiguous form's 128 at hd 64, 64 at hd 112 and 128 (the rows of 256
    bytes, two swizzled halves, take twice the shared memory and the O
    accumulator twice the registers); the cross form's (``"cross"``),
    the paged chunk's (``"chunk"``) and the window form's (``"ring"``)
    64 at every head dim.  A mirror, so that the split rules
    (:func:`cross_splits`, :func:`chunk_splits`, :func:`ring_splits`) run
    on the CPU too; chip_smoke.py's device phase holds it to the value
    the library reports (:func:`wgmma_occupancy`)."""
    return 128 if hd == 64 and form == "flash" else 64


def wgmma_smem_bytes(hd: int, form: str = "flash") -> int:
    """Dynamic shared memory of a wgmma body (``wgt::Cfg::kSmem``): 1024
    bytes of alignment slack, Q's WGMMA_ROWS rows of the body's head dim
    (:func:`wgmma_body_hd`: hd 112 takes the hd-128 body's) in bf16, a
    ring of K and V tiles (3 stages of the contiguous form's at hd 64, 4
    stages elsewhere: 83,200 bytes at hd 64 and 165,120 at 112 and 128
    for the cross, chunk and ring forms), 256 bytes of barriers.  A
    mirror, held to the library's value as :func:`wgmma_tile_keys` is."""
    stages = 3 if (hd, form) == (64, "flash") else 4
    width = wgmma_body_hd(hd)
    return (1024 + WGMMA_ROWS * width * 2
            + 2 * stages * wgmma_tile_keys(hd, form) * width * 2 + 256)


def flash_body(dtype: torch.dtype, hd: int, aligned: bool = True) -> str:
    """The contiguous form's body: ``"wgmma"`` for bfloat16 at a head dim
    of :data:`WGMMA_HD` with 16-byte aligned tensors and strides (every
    launch of smollm-360m's and zamba2-7b's train steps, and
    llama-3.2-vision-90b's and seamless-m4t-medium's ``Model.prefill``),
    else :func:`prefill_body`'s choice (``"mma"`` at the other bf16 head
    dims it takes, 256 among them; ``"cuda_core"`` for float32).  A group
    of more than WGMMA_ROWS heads is refused by the kernel."""
    if dtype == torch.bfloat16 and aligned and hd in WGMMA_HD:
        return "wgmma"
    return prefill_body(dtype, hd, aligned)


def cross_body(dtype: torch.dtype, hd: int, aligned: bool = True) -> str:
    """The cross form's body: ``"wgmma"`` for bfloat16 at a head dim of
    :data:`CROSS_WGMMA_HD` with the cross wrapper's ``aligned`` (16-byte
    aligned q and pools, and blocks of whole 8-slot swizzle atoms or one
    block a row: every cross read of seamless-m4t-medium and
    llama-3.2-vision-90b, chunk and ``Model.prefill``), else
    :func:`prefill_body`'s choice (hd 112 among them: the cross kernel
    has no hd-112 body); float32 keeps ``cuda_core``, so the card's
    float32 streams stay equal to the CPU's."""
    if dtype == torch.bfloat16 and aligned and hd in CROSS_WGMMA_HD:
        return "wgmma"
    return prefill_body(dtype, hd, aligned)


def chunk_body(dtype: torch.dtype, hd: int, aligned: bool = True,
               segments: bool = True) -> str:
    """The paged chunk's body (the one-row prefill and the batched form
    share it, so a batched row keeps a one-row call's bits): ``"wgmma"``
    (``csrc/chunk_wgmma.cu``) for bfloat16 at a head dim of
    :data:`CHUNK_WGMMA_HD` with 16-byte aligned q, pools and out and
    pools whose blocks cut into whole 8-slot TMA segments (``segments``:
    bs a multiple of 8, or one block a row); else :func:`prefill_body`'s
    choice (``"mma"`` at the other bf16 shapes it takes, hd 256 among
    them; ``"cuda_core"`` for float32, so the card's float32 streams stay
    equal to the CPU's).  Not the chunk's length: on the H100 the wgmma
    body beat ``mma`` in turns at every C from 1 to 64 over 512 slots
    and at C 128 over 256 to 2048 (smollm-360m, zamba2-7b, the hd-128
    G-8 chunk, seamless-m4t-medium) and at the verify round's B 8 x C 5
    (``tools/torch_split_sweep.py --chunk``, PERF.md §6); only a
    prompt's first chunk (pos 0) takes it longer, 1.2x.  Never the batch,
    pos or the table."""
    if (dtype == torch.bfloat16 and aligned and segments
            and hd in CHUNK_WGMMA_HD):
        return "wgmma"
    return prefill_body(dtype, hd, aligned)


#: key tiles (of 64 keys) a CTA of the cross form's split takes at
#: least: a CTA's fixed cost (its start, first copies and the cluster
#: merge) is several tiles' worth, so splitting finer buys a chunk's
#: B 1 less than it costs ``Model.prefill``'s B 8
#: (``tools/torch_split_sweep.py --cross``: at seamless-m4t-medium's
#: shape 6 splits take 0.0115 ms at B 1 but 0.083 at B 8, 2 splits 0.020
#: and 0.040, the mma body 0.025 and 0.051; PERF.md §6)
CROSS_MIN_TILES = 8


def cross_splits(c: int, h: int, kv: int, hd: int, n_keys: int) -> int:
    """CTAs (one cluster) each (row tile, KV head) of the cross form's
    wgmma body splits its ``ceil(n_keys / 64)`` key tiles across:
    :func:`wide_splits` over one row's row tiles of WGMMA_ROWS rows x KV
    heads (the body holds one CTA an SM as the wide bodies do), and no
    more than leave each CTA CROSS_MIN_TILES tiles (2 at
    llama-3.2-vision-90b's chunk: 8 x 8 units, 128 CTAs; 2 at
    seamless-m4t-medium's: 16 units, 32 CTAs).  Shapes only, not B, bs
    or the table: a row of a batched launch gets a one-row call's split
    and bits."""
    tiles = -(-c // (WGMMA_ROWS // (h // kv)))
    nt = -(-n_keys // wgmma_tile_keys(hd, "cross"))
    return min(wide_splits(tiles * kv, nt), max(1, nt // CROSS_MIN_TILES))


#: key tiles (of 64 keys) a CTA of the chunk forms' wgmma split takes at
#: least, at capacity: a CTA's fixed cost (its start, Q, the first
#: copies and the cluster merge) is a few tiles' worth
CHUNK_MIN_TILES = 4
#: a chunk of at most CHUNK_SHORT_C queries (a verify round's K + 1, a
#: prompt's last few tokens) splits at most CHUNK_SHORT_SPLITS ways: the
#: batched form's B rows fill the card beside it (B 8 x C 5 at
#: smollm-360m's and qwen2-72b's heads took 0.0103 / 0.0142 ms on 2
#: splits, 0.0137 / 0.0217 on 4 on the H100; a one-row chunk of 1-8
#: queries, a prompt's rare tail, takes up to 1.34x its 4-split time on
#: 2 there; PERF.md §6)
CHUNK_SHORT_C = 8
CHUNK_SHORT_SPLITS = 2


def _wgmma_row_tiles(c: int, h: int, kv: int) -> int:
    """Row tiles of one row: WGMMA_ROWS // G whole queries a CTA."""
    return -(-c // max(1, WGMMA_ROWS // (h // kv)))


def chunk_splits(c: int, h: int, kv: int, hd: int, capacity: int) -> int:
    """CTAs (one cluster) each (row tile, KV head) of the paged chunk's
    wgmma body splits its key tiles across: :func:`wide_splits` over one
    row's row tiles x KV heads (the body holds one CTA an SM) and the
    ``ceil(capacity / 64)`` tiles of a full row (``capacity`` = nb * bs),
    and no more than leave each CTA CHUNK_MIN_TILES of them (4 at
    smollm-360m's chunk: 20 units; 3 at zamba2-7b's: 32 units, 96 CTAs; 2
    at llama-3.2-vision-90b's attn layers: 64 units), nor more than
    CHUNK_SHORT_SPLITS for a chunk of at most CHUNK_SHORT_C queries.
    Shapes only: each CTA cuts its share from the tiles it derives from
    pos on the device, so a row of a batched launch gets a one-row call's
    split and bits."""
    nt = -(-capacity // wgmma_tile_keys(hd, "chunk"))
    splits = min(wide_splits(_wgmma_row_tiles(c, h, kv) * kv, nt),
                 max(1, nt // CHUNK_MIN_TILES))
    return min(splits, CHUNK_SHORT_SPLITS) if c <= CHUNK_SHORT_C else splits


#: CTAs of a wgmma body an SM holds: one (its registers: 168 a thread at
#: launch, 384 threads); chip_smoke.py checks it against the card at
#: each head dim, for every form
WGMMA_CTAS_PER_SM = 1


def cross_wgmma_clusters(hd: int, splits: int) -> int:
    """Clusters of ``splits`` CTAs of the cross form's wgmma body at head
    dim ``hd`` the card holds at once, from the occupancy calculator on
    the kernel itself (card only): what :func:`cross_splits` reads from
    ``WIDE_CLUSTERS``."""
    out = ctypes.c_int(0)
    _build.check(_build.library().rt_cross_wgmma_clusters(
        hd, splits, ctypes.byref(out)), "cross wgmma clusters")
    return out.value


def chunk_wgmma_clusters(hd: int, splits: int, form: str = "chunk") -> int:
    """Clusters of ``splits`` CTAs of the paged chunk's (``"chunk"``) or
    the window form's (``"ring"``) wgmma body at head dim ``hd`` the card
    holds at once, from the occupancy calculator on the kernel itself
    (card only): what :func:`chunk_splits` and :func:`ring_splits` read
    from ``WIDE_CLUSTERS``."""
    out = ctypes.c_int(0)
    _build.check(_build.library().rt_chunk_wgmma_clusters(
        hd, int(form == "ring"), splits, ctypes.byref(out)),
        f"{form} wgmma clusters")
    return out.value


def wgmma_occupancy(hd: int = 64, form: str = "flash") -> tuple:
    """(CTAs an SM of this card holds, dynamic shared memory, keys a K/V
    tile) of a wgmma body at head dim ``hd``: the contiguous
    (``form="flash"``), the cross (``"cross"``), the paged chunk's
    (``"chunk"``) or the window form's (``"ring"``); the CTAs from the
    card's occupancy calculator on the kernel itself, the others the
    kernel's own constants (card only)."""
    ctas, smem, keys = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    lib = _build.library()
    out = (ctypes.byref(ctas), ctypes.byref(smem), ctypes.byref(keys))
    if form in ("chunk", "ring"):
        rc = lib.rt_chunk_wgmma_occupancy(hd, int(form == "ring"), *out)
    else:
        rc = (lib.rt_flash_wgmma_occupancy if form == "flash"
              else lib.rt_cross_wgmma_occupancy)(hd, *out)
    _build.check(rc, f"{form} wgmma occupancy")
    return ctas.value, smem.value, keys.value


def prefill_span(hd: int) -> int:
    """Logical slots a CTA of the mma body takes per step (``Tiles::kSpan``:
    two key groups of 64 slots up to hd 128, of 32 at 256)."""
    return 2 * (32 if hd > 128 else 64)


def prefill_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of the mma body (``mma::smem_bytes``): Q's
    PREFILL_ROWS rows and two K and two V buffers of a step's slots, rows
    padded to hd + 8 bf16."""
    return (PREFILL_ROWS + 4 * prefill_span(hd)) * (hd + 8) * 2


def ring_body(dtype: torch.dtype, hd: int, aligned: bool = True,
              segments: bool = True) -> str:
    """The window form's body: ``"wgmma"`` (``csrc/chunk_wgmma.cu``) for
    bfloat16 at a head dim of :data:`RING_WGMMA_HD` with 16-byte aligned
    q, pools, chunk K/V and out and a ring whose blocks cut into whole
    8-slot TMA segments (``segments``: bs a multiple of 8, or one dense
    block); else ``"mma"`` where :func:`prefill_body` names it (the other
    bf16 head dims of whole k16 steps up to 128, and 256), else
    ``"cuda_core"``, so float32 keeps the card's streams equal to the
    CPU's."""
    if (dtype == torch.bfloat16 and aligned and segments
            and hd in RING_WGMMA_HD):
        return "wgmma"
    return prefill_body(dtype, hd, aligned)


def ring_splits(c: int, h: int, kv: int, hd: int, w: int,
                body: str = "mma") -> int:
    """CTAs (one cluster) each row tile's key tiles of the window form are
    split across.  On ``"wgmma"``: :func:`wide_splits` over one chunk's
    row tiles of WGMMA_ROWS rows x KV heads and the 64-key tiles of a full
    ring plus a whole chunk, leaving each CTA at least CHUNK_MIN_TILES of
    them (3 at mixtral-8x7b's chunk: 4 x 8 units over 64 + 2 tiles).  On
    ``"mma"``: 1 up to hd 128; at hd 256, :func:`wide_splits` over the
    row tiles x KV heads and the steps of a full ring plus a whole chunk
    (3 at gemma3's chunk: 32 units over 16 + 2 steps).  Shapes only: the
    tiles each CTA takes are cut from ``pos`` on the device."""
    if body == "wgmma":
        tk = wgmma_tile_keys(hd, "ring")
        nt = -(-w // tk) + -(-c // tk)
        return min(wide_splits(_wgmma_row_tiles(c, h, kv) * kv, nt),
                   max(1, nt // CHUNK_MIN_TILES))
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
    forces a kernel body over :func:`chunk_body`'s choice, for timing
    the bodies against each other; the model never passes it."""
    if fake.is_abstract(q):
        return fake.paged_prefill(q, k_pool, v_pool, table)
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
    body, splits = _chunk_body_and_splits(q, k_pool, v_pool, out, c, h, kv,
                                          hd, bs, nb, _body)
    lib = _build.library()
    _build.launches["paged_prefill_attention"] += 1
    _build.bodies["paged_prefill_attention"][body] += 1
    _build.check(lib.rt_paged_prefill_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        out.data_ptr(), c, h, kv, hd, bs, nb, nbp, pos, float(scale),
        _build.dtype_code(q.dtype), _build.BODY_CODES[body], splits,
        torch.cuda.current_stream(q.device).cuda_stream),
        "paged_prefill_attention")
    return out


def _chunk_body_and_splits(q, k_pool, v_pool, out, c, h, kv, hd, bs, nb,
                           body):
    """The paged chunk's body (``body``, else :func:`chunk_body`'s) and
    the split of the body it launches."""
    body = body or chunk_body(
        q.dtype, hd,
        all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool, out)),
        nb == 1 or bs % 8 == 0)
    splits = (chunk_splits(c, h, kv, hd, nb * bs) if body == "wgmma"
              else prefill_splits(c, h, kv, hd, nb * bs) if body == "mma"
              else 1)
    return body, splits


def paged_chunk_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          pos: torch.Tensor, scale: Optional[float] = None,
                          _body: Optional[str] = None) -> torch.Tensor:
    """Batched paged causal chunk attention, each row's ``pos`` read on
    the device; see :func:`paged_chunk_attention_plain` for the contract
    and :func:`paged_prefill_attention` for ``_body``."""
    if fake.is_abstract(q):
        return fake.paged_chunk(q, k_pool, v_pool, tables)
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
    body, splits = _chunk_body_and_splits(q, k_pool, v_pool, out, c, h, kv,
                                          hd, bs, nb, _body)
    lib = _build.library()
    _build.launches["paged_chunk_attention"] += 1
    _build.bodies["paged_chunk_attention"][body] += 1
    _build.check(lib.rt_paged_chunk_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(), b, c, h, kv, hd,
        bs, nb, nbp, float(scale), _build.dtype_code(q.dtype),
        _build.BODY_CODES[body], splits,
        torch.cuda.current_stream(q.device).cuda_stream),
        "paged_chunk_attention")
    return out


def paged_cross_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, tables: torch.Tensor,
                                n_keys: int,
                                scale: Optional[float] = None) -> torch.Tensor:
    """The cross form: gather each row's first ``n_keys`` slots, f32
    scores, softmax over all of them (no mask), P V, as the reference's
    ``cross_attention`` computes them (``_gqa_scores`` / ``_gqa_out``)
    over the row's cross K/V.  q (B,C,H,hd); pools (NB,bs,KV,hd); tables
    (B,nb) with nb * bs >= n_keys.  Returns (B,C,H,hd) in q.dtype."""
    b, c, h, hd = q.shape
    kv = k_pool.shape[2]
    g = h // kv
    scale = hd ** -0.5 if scale is None else scale
    kg = paged_gather(k_pool, tables)[:, :n_keys].float()
    vg = paged_gather(v_pool, tables)[:, :n_keys].float()
    qg = q.reshape(b, c, kv, g, hd).float()
    scores = torch.einsum("bqngh,bsnh->bngqs", qg, kg) * scale  # (B,KV,G,C,S)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngqs,bsnh->bqngh", probs, vg)
    return out.reshape(b, c, h, hd).to(q.dtype)


def paged_cross_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          n_keys: int, scale: Optional[float] = None,
                          _body: Optional[str] = None) -> torch.Tensor:
    """Cross-attention of B rows of C queries over the first ``n_keys``
    slots of each row's blocks, unmasked; see
    :func:`paged_cross_attention_plain` for the contract and
    :func:`paged_prefill_attention` for ``_body``.  The pools are read in
    place."""
    if fake.is_abstract(q):
        return fake.paged_cross(q, k_pool, v_pool, tables, int(n_keys))
    if q.device.type == "cpu":
        return paged_cross_attention_plain(q, k_pool, v_pool, tables, n_keys,
                                           scale)
    b, c, h, hd = q.shape
    nbp, bs, kv, hd_k = k_pool.shape
    nb = tables.shape[-1]
    n_keys = int(n_keys)
    scale = hd ** -0.5 if scale is None else scale
    tensors = (q, k_pool, v_pool, tables)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("paged_cross_attention: all tensors must lie on one "
                         "CUDA device")
    if (hd_k != hd or v_pool.shape != k_pool.shape or h % kv
            or tables.shape != (b, nb) or b > 65535
            or not 0 < n_keys <= nb * bs):
        raise ValueError(
            f"paged_cross_attention: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, tables "
            f"{tuple(tables.shape)}, n_keys {n_keys} do not fit")
    if (k_pool.dtype != q.dtype or v_pool.dtype != q.dtype
            or tables.dtype != torch.int32):
        raise TypeError("paged_cross_attention: q and pools must share a "
                        "dtype; tables must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_cross_attention: the kernel takes contiguous "
                         "tensors")
    out = torch.empty_like(q)
    body = _body or cross_body(
        q.dtype, hd,
        all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool))
        and (nb == 1 or bs % 8 == 0))
    splits = (cross_splits(c, h, kv, hd, n_keys) if body == "wgmma"
              else prefill_splits(c, h, kv, hd, n_keys) if body == "mma"
              else 1)
    lib = _build.library()
    _build.launches["paged_cross_attention"] += 1
    _build.bodies["paged_cross_attention"][body] += 1
    _build.check(lib.rt_paged_cross_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        out.data_ptr(), b, c, h, kv, hd, bs, nb, nbp, n_keys, float(scale),
        _build.dtype_code(q.dtype), _build.BODY_CODES[body], splits,
        torch.cuda.current_stream(q.device).cuda_stream),
        "paged_cross_attention")
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
    if fake.is_abstract(q):
        return fake.ring_chunk(q, k_pool, v_pool, table, k_new, v_new, int(w))
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
    body = _body or ring_body(
        q.dtype, hd,
        all(t.data_ptr() % 16 == 0
            for t in (q, k_pool, v_pool, k_new, v_new, out)),
        nb == 1 or bs % 8 == 0)
    splits = ring_splits(c, h, kv, hd, w, body) if body != "cuda_core" else 1
    lib = _build.library()
    _build.launches["ring_chunk_attention"] += 1
    _build.bodies["ring_chunk_attention"][body] += 1
    _build.check(lib.rt_ring_chunk_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(),
        pos_dev.data_ptr() if pos_dev is not None else None, out.data_ptr(),
        c, h, kv, hd, bs, nb, nbp, pos, w, float(scale),
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
    out takes q's layout; the body is :func:`flash_body`'s.  ``_body`` as
    in :func:`paged_prefill_attention`; a shape the body cannot take
    raises."""
    if fake.is_abstract(q):
        return fake.flash(q, k, v, bool(causal), int(window))
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
    body = _body or flash_body(q.dtype, hd, aligned)
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
    ``apply(q, k, v, causal, window, scale)`` returns out; a seventh
    argument forces the forward's body (``_body`` of
    :func:`flash_attention`; the model never passes it)."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=0, scale=None,
                _body=None):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, _body=_body)
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
        return dq, dk, dv, None, None, None, None


def cross_attention_backward(q, k, v, dout, scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of the cross form over dense K/V in torch
    ops, the algebra of :func:`flash_attention_backward` in blocks of
    :data:`FLASH_Q_BLOCK` queries over every key (no mask), the row's
    probabilities recomputed in f32: P = softmax(s Q K^T), dV = P^T dO,
    dP = dO V^T, dS = P (dP - rowsum(P dP)), dQ = s dS K and dK = s dS^T
    Q, dK and dV summed over the G heads of a group.  q, dout (B,C,H,hd);
    k, v (B,S,KV,hd).  Each gradient in its input's dtype."""
    b, c, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = d ** -0.5 if scale is None else scale
    kf, vf = k.float(), v.float()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for q0 in range(0, c, FLASH_Q_BLOCK):
        q1 = min(q0 + FLASH_Q_BLOCK, c)
        qb = q[:, q0:q1].float().reshape(b, q1 - q0, kv, g, d)
        dob = dout[:, q0:q1].float().reshape(b, q1 - q0, kv, g, d)
        p = torch.softmax(torch.einsum("bqngd,bsnd->bngqs", qb, kf) * scale,
                          dim=-1)
        dv += torch.einsum("bngqs,bqngd->bsnd", p, dob)
        dp = torch.einsum("bqngd,bsnd->bngqs", dob, vf)
        ds = p.mul_(dp.sub_((p * dp).sum(dim=-1, keepdim=True)))
        dq[:, q0:q1] = torch.einsum("bngqs,bsnd->bqngd", ds, kf).reshape(
            b, q1 - q0, h, d) * scale
        dk += torch.einsum("bngqs,bqngd->bsnd", ds, qb) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class CrossAttentionFn(torch.autograd.Function):
    """The cross form over dense K/V with a gradient (train mode's cross
    reads: ``models/attention.py::cross_attention``).  ``apply(q, k, v)``
    with q (B,C,H,hd) and k, v (B,S,KV,hd) returns (B,C,H,hd): the
    forward is :func:`paged_cross_attention` over identity tables (the
    dense K/V as B blocks of S slots; the kernel on a CUDA tensor, the
    plain version on a CPU one), and saves q, k and v; the backward is
    :func:`cross_attention_backward` (torch ops, as the flash kernel's
    is: the reference differentiates its jnp ``cross_attention``) under
    the profiler label ``cross_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v):
        tables = torch.arange(q.shape[0], dtype=torch.int32,
                              device=q.device)[:, None]
        out = paged_cross_attention(q, k, v, tables, k.shape[1])
        ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        with torch.profiler.record_function("cross_attention_backward"):
            return cross_attention_backward(q, k, v, dout)
