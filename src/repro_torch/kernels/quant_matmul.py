"""Weight-only int8 / int4 dequantize-matmul: the CUDA kernels' wrappers
and their plain PyTorch versions.

Port of ``repro/kernels/quant_matmul.py::quant_matmul_pallas`` (bodies
``_qmm_int8_kernel`` and ``_qmm_int4_kernel``,
``src/repro/kernels/quant_matmul.py:54``): ``x (..., K) @ dequant(q, s)
-> (..., N)`` in x's dtype, accumulated in f32.  The kernels are
``csrc/quant_matmul.cu``.  Bound on the H100: bytes (each weight byte is
used M times, far below the tensor cores' 295 flops per byte), and in
practice latency and SM fill at decode.

* int8: ``q`` (K, N) int8, ``s`` (1, N) f32; ``(x @ q) * s`` with the
  scale applied once, after the sum over K.
* int4: ``q`` (K//2, N) uint8 (packed row r: k = 2r in the low nibble,
  k = 2r+1 in the high, both biased by +8), ``s`` (K//G, N) f32;
  ``x @ ((nibble - 8) * s[k // G])`` with the scale inside the sum.

The plain versions follow the reference model's ``_qdot_int8`` /
``_qdot_int4`` (``repro/models/quantize.py``) including their K-chunked
f32 accumulation (``_chunk_len``), so the port's float32 streams sum
in the reference's order.  The wrappers run the plain version for CPU
tensors only; for CUDA tensors they launch the kernel or raise.

Each format's kernel has three bodies, named by :func:`int8_body` and
:func:`int4_body`:

* ``"wgmma"`` (bfloat16, ``N % 16 == 0``, ``K % 16 == 0``, 16-byte
  aligned x, q and (int4) s, and for int4 ``G % 16 == 0``; every bf16
  launch the served models make but smollm-360m's small sites: int8
  at every M, ``WGMMA_INT8_MIN_BYTES``, and int4's attention
  projections above 64 rows, ``WGMMA_INT4_CHUNK_MIN``): the
  warp-specialised Hopper body,
  ``csrc/quant_wgmma.cu``.  One producer warp feeds a ring of K stages
  of 64 by TMA (the weight's rows, x's rows, int4's scale rows), and two
  consumer warpgroups of 64 output columns each turn their weight bytes
  (``ldmatrix.trans``) into exact bf16 integers in registers, the A
  operand of ``wgmma`` m64nNk16 over x's rows (N = 8 to 128,
  :func:`wgmma_rows`); int4 at groups of 64 sums each stage's group in
  one of two accumulators in turns (one at N = 128) and scales it in f32
  beside the next stage's products, other groups as each ends.  K is
  split across a cluster by :func:`wgmma_splits`.
* ``"mma"`` (the same conditions but s's alignment; int8 below
  ``WGMMA_INT8_MIN_BYTES`` of weight, int4 below
  ``WGMMA_INT4_CHUNK_MIN`` values above 64 rows or with s off 16
  bytes, and ``_body="mma"`` for timing in turns): the transposed
  product ``out^T = W^T x^T`` on the tensor cores (``mma.sync`` m16n8k16, f32 accumulators), N on the m16
  side and M on the n8 side, weights turned into exact bf16 integers
  (int4 nibbles; int8 bytes paired across two rows of q), int4's scale
  groups summed apart and scaled in f32, int8's scale applied after the
  sum; K is split across the CTAs of a cluster (:func:`quant_splits`,
  one rule for both formats).
* ``"cuda_core"`` (float32 at every shape, bfloat16 at the others): the
  f32 CUDA-core body.  float32 stays there because the card's f32
  streams must equal the CPU's, and TF32 tensor cores would round x.

The tensor-core bodies sum split-K partials in a fixed order through
distributed shared memory and choose splits from shapes alone, so
results do not depend on timing.
"""
from __future__ import annotations

import ctypes

import torch

from typing import Optional

from repro_torch.kernels import _build, fake
from repro_torch.kernels.decode_attention import WIDE_CLUSTERS

SM_COUNT = 132            # H100 SXM
MMA_TILE_N = 64           # csrc/quant_matmul.cu: mma::kTileN
MMA_STAGE_K = 64          # mma::kTileK
MMA_MAX_SPLITS = 8        # mma::kMaxSplits, a portable cluster
WGMMA_TILE_N = 128        # csrc/quant_wgmma.cu: kTileN (2 warpgroups x 64)
WGMMA_STAGE_K = 64        # kTileK
WGMMA_MAX_SPLITS = 8      # kMaxSplits, a portable cluster
WGMMA_MAX_STAGES = 16     # kMaxStages
WGMMA_MAX_GRID_Y = 65535  # output tiles ride the grid's y dimension
#: int8 weights of fewer bytes (K * N) than this keep the mma body: at
#: smollm-360m's sites (0.3 to 2.5 MB) the wgmma body's fixed cost (a CTA
#: of 288 threads and ~110 KB of shared memory, its first copies, the
#: cluster merge) made its decode rows 11-26% slower than mma's in turns
#: (at its MLP's 128-row chunk 13-26% faster, but the int8 rule names
#: one body a site at every M); from qwen2-72b's smallest site
#: (8.4 MB) up it is 1.3-4.4x faster (``tools/torch_split_sweep.py
#: --quant``, PERF.md)
WGMMA_INT8_MIN_BYTES = 1 << 22
#: int4 weights of fewer values (K * N) than this keep the mma body
#: above 64 rows of x, where the wgmma body runs its n128 tile: at
#: smollm-360m's 128-row prefill chunk its wq / wo (960 -> 960) and wk /
#: wv (960 -> 320) took 1.04x / 1.23x mma's time in turns, its MLP (2.5 M
#: values) 0.72-0.82x; at 8 to 64 rows wgmma took 0.94-1.03x at those
#: two sites (``tools/torch_split_sweep.py --quant``, PERF.md)
WGMMA_INT4_CHUNK_MIN = 1 << 21
#: the wgmma body's shared-memory budget for its ring, by CTAs an SM
#: (``Cfg::kBudget``): two CTAs an SM at n8 and n16, whose 12 stages
#: each streamed up to 16% faster than one CTA's 16 (qwen2-72b's int4
#: 8 x 8192 -> 29568; ``tools/torch_split_sweep.py --quant``'s
#: ``one_cta_an_sm`` variant)
WGMMA_BUDGET = {2: 110 * 1024, 1: 220 * 1024}
#: clusters of 1-8 CTAs of the wgmma body the card holds at once, by the
#: body's CTAs an SM (``rt_quant_wgmma_clusters``; chip_smoke.py holds
#: every shape's to these): at one CTA an SM the wide bodies' table.
#: The split rule reads the one-CTA table at every shape (a cluster
#: counted as if it had its SMs alone), which picks the sweep's fastest
#: count or one within 7% of it (:func:`wgmma_splits`)
WGMMA_CLUSTERS = {1: WIDE_CLUSTERS,
                  2: {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32,
                      8: 30}}


def wgmma_takes(k: int, n: int, group: Optional[int] = None) -> bool:
    """Whether the wgmma body takes K, N (and int4's group): whole k16
    steps and 16-byte tensor-map strides, groups of whole k16 steps that
    divide K, and N's 128-column tiles within a grid dimension."""
    ok = (k > 0 and k % 16 == 0 and n > 0 and n % 16 == 0
          and -(-n // WGMMA_TILE_N) <= WGMMA_MAX_GRID_Y)
    if group is not None:
        ok = ok and group > 0 and group % 16 == 0 and k % group == 0
    return ok


def int8_body(dtype: torch.dtype, k: int, n: int,
              aligned: bool = True) -> str:
    """The int8 kernel body a launch takes: for bfloat16 with K and N the
    wgmma body takes (:func:`wgmma_takes`) and 16-byte aligned x and q,
    ``"wgmma"`` from ``WGMMA_INT8_MIN_BYTES`` of weight up and ``"mma"``
    below (whose tiles take the same shapes); else ``"cuda_core"``."""
    if dtype == torch.bfloat16 and aligned and wgmma_takes(k, n):
        return "wgmma" if k * n >= WGMMA_INT8_MIN_BYTES else "mma"
    return "cuda_core"


def int4_body(dtype: torch.dtype, m: int, k: int, n: int, group: int,
              aligned: bool = True, s_aligned: bool = True) -> str:
    """The int4 kernel body a launch of M rows takes, for bfloat16 with
    scale groups of whole k16 steps that divide K, N on the m16 tiles
    and 16-byte aligned x and q: ``"wgmma"`` where the wgmma body takes
    K, N and the group (:func:`wgmma_takes`) and s is 16-byte aligned
    too, but for weights under ``WGMMA_INT4_CHUNK_MIN`` values above 64
    rows (its n128 tile, :func:`wgmma_rows`); else ``"mma"``.  Any other
    launch takes ``"cuda_core"``."""
    if not (dtype == torch.bfloat16 and aligned and group > 0
            and group % 16 == 0 and k % group == 0 and n % 16 == 0):
        return "cuda_core"
    if (s_aligned and wgmma_takes(k, n, group)
            and (wgmma_rows("int4", m) < 128
                 or k * n >= WGMMA_INT4_CHUNK_MIN)):
        return "wgmma"
    return "mma"


def wgmma_rows(fmt: str, m: int) -> int:
    """Rows of x a CTA of the wgmma body takes, its wgmma N
    (``tiles_m``): 8, 16, 32, 64 or 128, for either format."""
    for rows in (8, 16, 32, 64):
        if m <= rows:
            return rows
    return 128


def wgmma_ctas_per_sm(rows: int) -> int:
    """CTAs an SM of the wgmma body at ``rows`` rows (``Cfg::kCtasPerSm``;
    chip_smoke.py holds it to the card's occupancy calculator)."""
    return 2 if rows <= 16 else 1


def wgmma_stage_bytes(fmt: str, rows: int) -> int:
    """Shared bytes a stage of the wgmma body: the weight tile (int8 64
    rows, int4 32 packed rows of 128 bytes), x's rows of 64 bf16, and
    int4's four scale rows of 128 f32."""
    w = (WGMMA_STAGE_K // 2 if fmt == "int4" else WGMMA_STAGE_K) * WGMMA_TILE_N
    return w + rows * 128 + (4 * WGMMA_TILE_N * 4 if fmt == "int4" else 0)


def wgmma_stages(fmt: str, rows: int) -> int:
    """Stages of the wgmma body's ring (``Cfg::kStages``): its budget
    over a stage's bytes, at most ``WGMMA_MAX_STAGES``."""
    return min(WGMMA_MAX_STAGES, WGMMA_BUDGET[wgmma_ctas_per_sm(rows)]
               // wgmma_stage_bytes(fmt, rows))


def wgmma_smem_bytes(fmt: str, rows: int) -> int:
    """Dynamic shared memory of the wgmma body (``Cfg::kSmem``): 1024
    bytes of alignment slack, the ring, 256 bytes of barriers."""
    return 1024 + wgmma_stages(fmt, rows) * wgmma_stage_bytes(fmt, rows) + 256


def wgmma_splits(fmt: str, m: int, k: int, n: int) -> int:
    """Slices of K for the wgmma body of either format (one cluster of
    up to 8 CTAs per output tile of 128 columns by ``wgmma_rows`` rows),
    each whole stages of 64: the count whose waves of clusters at one
    CTA an SM (``WGMMA_CLUSTERS[1]``) times stages a slice is least, the
    fewest slices among equals.  On the H100, at M 8 and 128, it picks
    the fastest count at every qwen2-72b site and one within 1.0% of it at
    smollm-360m's int4 sites; at smollm-360m's int8 sites, which the
    rule keeps on mma, within 7% (``tools/torch_split_sweep.py
    --quant``, PERF.md).  Shapes only, never timing: the f32 summation
    order depends on M, K and N alone."""
    rows = wgmma_rows(fmt, m)
    stages = -(-k // WGMMA_STAGE_K)
    tiles = -(-n // WGMMA_TILE_N) * -(-m // rows)
    clusters = WGMMA_CLUSTERS[1]
    best, best_cost = 1, None
    for sp in range(1, min(WGMMA_MAX_SPLITS, stages) + 1):
        per = -(-stages // sp)
        if (sp - 1) * per >= stages:     # a slice would hold no stage
            continue
        cost = -(-tiles // clusters[sp]) * per
        if best_cost is None or cost < best_cost:
            best, best_cost = sp, cost
    return best


def wgmma_occupancy(fmt: str, rows: int) -> tuple:
    """(CTAs an SM of this card holds, dynamic shared memory, stages) of
    the wgmma body at ``rows`` rows of x: the CTAs from the card's
    occupancy calculator on the kernel itself, the others the kernel's
    own constants (card only)."""
    ctas, smem, stages = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_build.library().rt_quant_wgmma_occupancy(
        int(fmt == "int4"), rows, ctypes.byref(ctas), ctypes.byref(smem),
        ctypes.byref(stages)), "quant wgmma occupancy")
    return ctas.value, smem.value, stages.value


def wgmma_clusters(fmt: str, rows: int, splits: int) -> int:
    """Clusters of ``splits`` CTAs of the wgmma body at ``rows`` rows the
    card holds at once (card only): what :func:`wgmma_splits` reads from
    ``WGMMA_CLUSTERS``."""
    out = ctypes.c_int(0)
    _build.check(_build.library().rt_quant_wgmma_clusters(
        int(fmt == "int4"), rows, splits, ctypes.byref(out)),
        "quant wgmma clusters")
    return out.value


def mma_rows(m: int) -> int:
    """Rows of x per CTA of the mma body (``mma::dispatch``: 1, 2, 4 or
    8 n8 tiles)."""
    return 8 if m <= 8 else 16 if m <= 16 else 32 if m <= 32 else 64


def quant_splits(m: int, k: int, n: int) -> int:
    """Slices of K for the ``mma`` body of either format, and for no
    other body (one cluster of up to 8 CTAs per output tile of 64
    columns by ``mma_rows(M)`` rows),
    each whole K stages of 64: 2 KB of int4 or 4 KB of int8 weights, of
    which a slice's ring of 4 stages keeps 3 in flight.  Asks for two
    CTAs per SM over the output tiles, with at least one stage per slice
    at decode (M <= 16: every slice then starts all or most of its loads
    up front) and two for a chunk, whose CTAs carry up to 8 n8 tiles of
    mma work per weight fragment.  On the H100 it picked the ``mma``
    body's fastest of 1 to 8 slices for int8 at the main path's decode
    and chunk shapes, and for int4 one within 5% of it
    (``tools/torch_split_sweep.py --mma``).
    The split, and so the f32 summation order, depends on M, K and N
    only, never on timing or the format."""
    stages = -(-k // MMA_STAGE_K)
    tiles = -(-n // MMA_TILE_N) * -(-m // mma_rows(m))
    want = -(-2 * SM_COUNT // tiles)
    per = max(1 if m <= 16 else 2, -(-stages // want))
    return min(MMA_MAX_SPLITS, -(-stages // per))


def chunk_len(k: int, multiple: int = 1, cap: int = 256) -> int:
    """Largest divisor of K that is <= cap and a multiple of
    ``multiple`` (the int4 group, so one chunk's scales are whole rows);
    the reference's ``_chunk_len``."""
    best = multiple
    c = multiple
    while c <= cap:
        if k % c == 0:
            best = c
        c += multiple
    return best


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(…, K//2, N) uint8 -> (…, K, N) int8 in [-8, 7] (the layout of
    the module docstring)."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-2).reshape(
        *packed.shape[:-2], 2 * packed.shape[-2], packed.shape[-1])


def quant_matmul_int8_plain(x: torch.Tensor, q: torch.Tensor,
                            s: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ dequant(q (K, N) int8, s (1, N)): f32 partial sums
    over K-chunks, then the scale (``_qdot_int8``)."""
    k, n = q.shape
    c = chunk_len(k)
    xf = x.reshape(-1, k).to(torch.float32)
    acc = torch.zeros((xf.shape[0], n), dtype=torch.float32,
                      device=x.device)
    for i in range(0, k, c):
        acc = acc + xf[:, i:i + c] @ q[i:i + c].to(torch.float32)
    out = acc * s
    return out.to(x.dtype).reshape(*x.shape[:-1], n)


def quant_matmul_int4_plain(x: torch.Tensor, q: torch.Tensor,
                            s: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ dequant(q (K//2, N) packed, s (K//G, N)), K-chunked
    with chunks aligned to whole scale groups (``_qdot_int4``)."""
    k2, n = q.shape
    k = 2 * k2
    g = k // s.shape[-2]
    c = chunk_len(k, multiple=g)
    xf = x.reshape(-1, k).to(torch.float32)
    acc = torch.zeros((xf.shape[0], n), dtype=torch.float32,
                      device=x.device)
    for i in range(0, k, c):
        w = (unpack_int4(q[i // 2:(i + c) // 2]).to(torch.float32)
             * torch.repeat_interleave(s[i // g:(i + c) // g], g, dim=0))
        acc = acc + xf[:, i:i + c] @ w
    return acc.to(x.dtype).reshape(*x.shape[:-1], n)


def _launch(kind: str, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
            body: Optional[str] = None) -> torch.Tensor:
    name = f"quant_matmul_{kind}"
    k = x.shape[-1]
    n = q.shape[-1]
    tensors = (x, q, s)
    if x.device.type != "cuda" or any(a.device != x.device for a in tensors):
        raise ValueError(f"{name}: all tensors must lie on one CUDA device")
    want_q = torch.int8 if kind == "int8" else torch.uint8
    if q.dtype != want_q or s.dtype != torch.float32:
        raise TypeError(f"{name}: q must be {want_q} and s float32, got "
                        f"{q.dtype} / {s.dtype}")
    if q.dim() != 2 or s.dim() != 2 or s.shape[1] != n:
        raise ValueError(f"{name}: q {tuple(q.shape)} / s {tuple(s.shape)} "
                         f"are not a (K, N) weight")
    if kind == "int8":
        if q.shape[0] != k or s.shape[0] != 1:
            raise ValueError(f"{name}: x (..., {k}) against q "
                             f"{tuple(q.shape)}, s {tuple(s.shape)}")
        group = 0
    else:
        if 2 * q.shape[0] != k or s.shape[0] == 0 or k % s.shape[0]:
            raise ValueError(f"{name}: x (..., {k}) against packed q "
                             f"{tuple(q.shape)}, s {tuple(s.shape)}")
        group = k // s.shape[0]
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    m = x.numel() // k if k else 0
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    aligned = x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    s_aligned = kind == "int8" or s.data_ptr() % 16 == 0
    body = body or (int8_body(x.dtype, k, n, aligned) if kind == "int8"
                    else int4_body(x.dtype, m, k, n, group, aligned,
                                   s_aligned))
    if body == "wgmma" and not (
            x.dtype == torch.bfloat16 and aligned and s_aligned
            and wgmma_takes(k, n, group if kind == "int4" else None)):
        raise ValueError(f"{name}: the wgmma body does not take "
                         f"{x.dtype} x (..., {k}) against q "
                         f"{tuple(q.shape)} (x / q aligned: {aligned}, "
                         f"s aligned: {s_aligned})")
    splits = (quant_splits(m, k, n) if body == "mma" else
              wgmma_splits(kind, m, k, n) if body == "wgmma" else 1)
    lib = _build.library()
    entry = (lib.rt_quant_matmul_int8 if kind == "int8"
             else lib.rt_quant_matmul_int4)
    _build.launches[name] += 1
    _build.bodies[name][body] += 1
    _build.check(entry(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), m, k, n,
        group, _build.dtype_code(x.dtype), _build.BODY_CODES[body], splits,
        torch.cuda.current_stream(x.device).cuda_stream), name)
    return out


def quant_matmul_int8(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      _body: Optional[str] = None) -> torch.Tensor:
    """x (..., K) @ dequant(q, s) for an int8 leaf; see the module
    docstring for the layout.  ``_body`` forces a kernel body over
    :func:`int8_body`'s choice, for timing the bodies against each other;
    the model never passes it."""
    if fake.is_abstract(x):
        return fake.quant_matmul(x, q, s, q.shape[0])
    if x.device.type == "cpu":
        return quant_matmul_int8_plain(x, q, s)
    return _launch("int8", x, q, s, _body)


def quant_matmul_int4(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      _body: Optional[str] = None) -> torch.Tensor:
    """x (..., K) @ dequant(q, s) for a packed int4 leaf.  ``_body``
    forces a kernel body over :func:`int4_body`'s choice, as for int8;
    the model never passes it."""
    if fake.is_abstract(x):
        return fake.quant_matmul(x, q, s, 2 * q.shape[0])
    if x.device.type == "cpu":
        return quant_matmul_int4_plain(x, q, s)
    return _launch("int4", x, q, s, _body)
