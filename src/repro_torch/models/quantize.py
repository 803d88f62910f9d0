"""Weight-only quantization: packed parameter trees and the qdot dispatch.

Port of ``repro/models/quantize.py``.  ``quantize_params(params, fmt)``
rewrites the projection weights of a parameter tree into packed quant
leaves; everything else (embeddings, norms, biases, the tied head)
stays in the model dtype.  A quantized weight is a dict

    {"q": packed ints, "s": f32 scales}

so it slices per layer like any other leaf
(``models/transformer.py::_layer`` recurses into dicts).

Formats (the reference's, bit for bit):

* ``"int8"`` — per-output-channel symmetric: ``q`` int8 with the shape
  of ``w``; ``s`` f32 ``(..., 1, N)`` = amax over K / 127.
* ``"int4"`` — per-group along K (``group`` = 64, or gcd(K, group) when
  K is not a multiple): values clipped to [-8, 7], biased by +8 and
  packed two nibbles per byte — ``q`` uint8 ``(..., K//2, N)`` (packed
  row r holds k = 2r low, k = 2r+1 high); ``s`` f32 ``(..., K//G, N)``
  = per-group amax / 7.

Selection is by key name: exactly the dense projection weights
(``QUANT_KEYS``).  Odd-K weights stay dense under int4.

``qdot(x, w)`` is the one matmul entry point of the projection sites
(attention ``_proj_q`` / ``_proj_kv`` / ``wo``, ``layers.mlp``): a plain
tensor runs ``x @ w``, the op those sites always ran, so streams with
quantization off are bit-unchanged; a packed leaf runs the
dequantize-fused matmul of ``kernels/quant_matmul.py`` (a CUDA kernel
on the card, its plain version on the CPU).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.quant_matmul import (quant_matmul_int4,
                                              quant_matmul_int8, unpack_int4)

# Exactly the dense projection weights: QKV/O and the SwiGLU MLP.
QUANT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})

QFORMATS = (None, "bf16", "int8", "int4")
DEFAULT_GROUP = 64

# Nominal bytes per weight for capacity math: int8 = 1 byte, int4 = half
# a byte plus one f32 scale per 64-group.
BYTES_PER_PARAM = {None: 2.0, "bf16": 2.0, "int8": 1.0,
                   "int4": 0.5 + 4.0 / DEFAULT_GROUP}

# Per-format floor on the share of a quantized stream's tokens that must
# equal the unquantized stream's (the reference's golden policy, set on
# its smoke models).
GOLDEN_TOKEN_MATCH_FLOOR = {"int8": 0.6, "int4": 0.25}
GOLDEN_TOKEN_MATCH_EXCEPTIONS = {("mixtral-8x7b", "int4"): 0.0}


def golden_token_match_floor(arch: str, fmt: str) -> float:
    """Per-(arch, fmt) floor on the share of quantized tokens that must
    equal the unquantized stream's."""
    arch = arch.removesuffix("-smoke")
    return GOLDEN_TOKEN_MATCH_EXCEPTIONS.get((arch, fmt),
                                             GOLDEN_TOKEN_MATCH_FLOOR[fmt])


def normalize_format(fmt: Optional[str]) -> Optional[str]:
    """Validate a format name; ``"bf16"`` is the unquantized baseline."""
    if fmt not in QFORMATS:
        raise ValueError(f"unknown qformat {fmt!r}; known: {QFORMATS}")
    return None if fmt == "bf16" else fmt


def bytes_per_param(fmt: Optional[str]) -> float:
    """Nominal bytes/weight for format ``fmt`` (bf16 baseline 2.0)."""
    if fmt not in BYTES_PER_PARAM:
        raise ValueError(f"unknown qformat {fmt!r}; known: {QFORMATS}")
    return BYTES_PER_PARAM[fmt]


def is_quantized(w) -> bool:
    """True for a packed quant leaf (the qdot dispatch predicate)."""
    return isinstance(w, dict) and "q" in w and "s" in w


# ----------------------------------------------------------------------
# Per-array quantize / pack
# ----------------------------------------------------------------------
def quantize_int8(w: torch.Tensor) -> dict:
    """(…, K, N) -> {"q" int8 same shape, "s" f32 (…, 1, N)}."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    s = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(…, K, N) ints in [-8, 7] -> (…, K//2, N) uint8 (k = 2r low
    nibble, k = 2r+1 high nibble, both biased +8)."""
    u = (q + 8).to(torch.uint8)
    return u[..., 0::2, :] | (u[..., 1::2, :] << 4)


def int4_group(k: int, group: int = DEFAULT_GROUP) -> int:
    return group if k % group == 0 else math.gcd(k, group)


def quantize_int4(w: torch.Tensor, group: int = DEFAULT_GROUP) -> dict:
    """(…, K, N) -> {"q" uint8 (…, K//2, N), "s" f32 (…, K//G, N)}.

    K must be even (nibbles pack in pairs); G falls back to
    gcd(K, group) when K is not a multiple of ``group``.
    """
    wf = w.to(torch.float32)
    k, n = wf.shape[-2], wf.shape[-1]
    if k % 2:
        raise ValueError(f"int4 needs even K, got {k}")
    g = int4_group(k, group)
    wg = wf.reshape(*wf.shape[:-2], k // g, g, n)
    amax = wg.abs().amax(dim=-2, keepdim=True)
    s = torch.clamp(amax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(wg / s), -8, 7)
    q = q.reshape(*wf.shape[:-2], k, n).to(torch.int8)
    # reprolint: disable-next=quant-static-weights -- the port's
    # quantize.py owns its packers
    return {"q": pack_int4(q), "s": s[..., 0, :]}


def dequantize(w: dict) -> torch.Tensor:
    """Expand one quant leaf back to an f32 weight matrix."""
    if w["q"].dtype == torch.int8:                   # per-channel int8
        return w["q"].to(torch.float32) * w["s"]
    k = 2 * w["q"].shape[-2]                         # packed int4 per-group
    g = k // w["s"].shape[-2]
    return (unpack_int4(w["q"]).to(torch.float32)
            * torch.repeat_interleave(w["s"], g, dim=-2))


# ----------------------------------------------------------------------
# Tree rewrite
# ----------------------------------------------------------------------
def _quantize_leaf(w: torch.Tensor, fmt: str, group: int):
    if w.ndim < 2 or (fmt == "int4" and w.shape[-2] % 2):
        return w                                     # stays dense
    if fmt == "int8":
        # reprolint: disable-next=quant-static-weights -- the port's
        # quantize.py owns its packers
        return quantize_int8(w)
    # reprolint: disable-next=quant-static-weights -- the port's
    # quantize.py owns its packers
    return quantize_int4(w, group)


def quantize_params(params, fmt: Optional[str],
                    group: int = DEFAULT_GROUP):
    """Rewrite every ``QUANT_KEYS`` weight of a parameter tree into a
    packed quant leaf.  Idempotent (packed leaves pass through) and a
    no-op for ``fmt`` in (None, "bf16").  The port's segments are
    stacked ``(n_layers, K, N)``; both formats quantize over the
    trailing (K, N), so each layer packs as the reference packs it.
    Packed leaves live on the weight's device."""
    fmt = normalize_format(fmt)
    if fmt is None:
        return params

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for key, val in node.items():
                if (key in QUANT_KEYS and isinstance(val, torch.Tensor)):
                    # reprolint: disable-next=quant-static-weights -- the
                    # port's quantize.py owns its packers
                    out[key] = _quantize_leaf(val, fmt, group)
                else:
                    out[key] = walk(val)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def dequantize_params(params, dtype=torch.bfloat16):
    """Expand every packed leaf back to dense weights in ``dtype``
    (round-trip testing; the serving path never calls this)."""
    def walk(node):
        if is_quantized(node):
            return dequantize(node).to(dtype)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


# ----------------------------------------------------------------------
# The matmul dispatch
# ----------------------------------------------------------------------
def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """Contract the last dim of ``x`` with the K dim of weight ``w``:
    ``x @ w`` for a plain tensor, the quant-matmul wrapper of its format
    for a packed leaf."""
    if is_quantized(w):
        if w["q"].dtype == torch.int8:
            return quant_matmul_int8(x, w["q"], w["s"])
        return quant_matmul_int4(x, w["q"], w["s"])
    return x @ w
