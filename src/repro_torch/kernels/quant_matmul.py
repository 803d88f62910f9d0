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

Each format's kernel has two bodies, named by :func:`int8_body` and
:func:`int4_body`:

* ``"mma"`` (bfloat16, ``N % 16 == 0``, ``K % 16 == 0``, 16-byte aligned
  x and q, and for int4 ``G % 16 == 0``; every bf16 launch the served
  models make): the transposed product ``out^T = W^T x^T`` on the
  tensor cores (``mma.sync`` m16n8k16, f32 accumulators), N on the m16
  side and M on the n8 side, weights turned into exact bf16 integers
  (int4 nibbles; int8 bytes paired across two rows of q), int4's scale
  groups summed apart and scaled in f32, int8's scale applied after the
  sum; K is split across the CTAs of a cluster (:func:`quant_splits`,
  one rule for both formats), whose partials are summed in a fixed
  order through distributed shared memory, so results do not depend on
  timing.
* ``"cuda_core"`` (float32 at every shape, bfloat16 at the others): the
  f32 CUDA-core body.  float32 stays there because the card's f32
  streams must equal the CPU's, and TF32 tensor cores would round x.
"""
from __future__ import annotations

import torch

from typing import Optional

from repro_torch.kernels import _build

SM_COUNT = 132            # H100 SXM
MMA_TILE_N = 64           # csrc/quant_matmul.cu: mma::kTileN
MMA_STAGE_K = 64          # mma::kTileK
MMA_MAX_SPLITS = 8        # mma::kMaxSplits, a portable cluster


def int8_body(dtype: torch.dtype, k: int, n: int,
              aligned: bool = True) -> str:
    """The int8 kernel body a launch takes: ``"mma"`` for bfloat16 with K
    and N on the tensor-core tiles (whole k16 steps, whole m16 tiles) and
    16-byte aligned x and q, else ``"cuda_core"``."""
    if dtype == torch.bfloat16 and n % 16 == 0 and k % 16 == 0 and aligned:
        return "mma"
    return "cuda_core"


def int4_body(dtype: torch.dtype, n: int, group: int,
              aligned: bool = True) -> str:
    """The int4 kernel body a launch takes: ``"mma"`` for bfloat16 with
    scale groups and N that the tensor-core tiles take and 16-byte
    aligned x and q, else ``"cuda_core"``."""
    if (dtype == torch.bfloat16 and group % 16 == 0 and n % 16 == 0
            and aligned):
        return "mma"
    return "cuda_core"


def mma_rows(m: int) -> int:
    """Rows of x per CTA of the mma body (``mma::dispatch``: 1, 2, 4 or
    8 n8 tiles)."""
    return 8 if m <= 8 else 16 if m <= 16 else 32 if m <= 32 else 64


def quant_splits(m: int, k: int, n: int) -> int:
    """Slices of K for the mma body of either format (one cluster of up
    to 8 CTAs per output tile of 64 columns by ``mma_rows(M)`` rows),
    each whole K stages of 64: 2 KB of int4 or 4 KB of int8 weights, of
    which a slice's ring of 4 stages keeps 3 in flight.  Asks for two
    CTAs per SM over the output tiles, with at least one stage per slice
    at decode (M <= 16: every slice then starts all or most of its loads
    up front) and two for a chunk, whose CTAs carry up to 8 n8 tiles of
    mma work per weight fragment.  On the H100 it picks the fastest of
    1 to 8 slices for int8 at the main path's decode and chunk shapes,
    and for int4 one within 5% of it (``tools/torch_split_sweep.py``).
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
    body = body or (int8_body(x.dtype, k, n, aligned) if kind == "int8"
                    else int4_body(x.dtype, n, group, aligned))
    splits = quant_splits(m, k, n) if body == "mma" else 1
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
    if x.device.type == "cpu":
        return quant_matmul_int8_plain(x, q, s)
    return _launch("int8", x, q, s, _body)


def quant_matmul_int4(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      _body: Optional[str] = None) -> torch.Tensor:
    """x (..., K) @ dequant(q, s) for a packed int4 leaf.  ``_body``
    forces a kernel body over :func:`int4_body`'s choice, as for int8;
    the model never passes it."""
    if x.device.type == "cpu":
        return quant_matmul_int4_plain(x, q, s)
    return _launch("int4", x, q, s, _body)
