"""Shared building blocks: norms, embeddings, rotary, MLPs.

Port of ``repro/models/layers.py``.  Functions take parameter dicts of
tensors in the reference's layout (projection weights ``(in, out)``, so
``x @ w``, or packed quant leaves, see ``models/quantize.py``); inits
take an explicit :class:`torch.Generator`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import add_rmsnorm as add_rmsnorm_kernel
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.models.quantize import qdot


def _dense_init(generator: torch.Generator, shape, dtype, device,
                scale=None) -> torch.Tensor:
    """Normal draws times ``fan_in ** -0.5`` (``shape[-2]``: the input
    dim of an ``(..., in, out)`` weight, stacked layers included)."""
    fan_in = shape[-2]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32).mul_(scale)
    return w.to(device=device, dtype=dtype)


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``layers.rmsnorm`` through the RMSNorm kernel's wrapper."""
    return rmsnorm_kernel(x, params["scale"], eps)


def add_rmsnorm(params: dict, x: torch.Tensor, delta: torch.Tensor,
                eps: float = 1e-5):
    """The residual add ``x + delta`` and ``layers.rmsnorm`` of its
    result, in one launch of the RMSNorm kernel.  Returns (x + delta,
    the normed row)."""
    return add_rmsnorm_kernel(x, delta, params["scale"], eps)


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table: a gather, whose gradient (train mode) sums each
    row's contributions in f32 on the card where an indexing gradient
    would add them into a bf16 table one by one."""
    return torch.nn.functional.embedding(tokens.long(), params["w"])


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """LM head (the tied embedding table or an untied ``lm_head`` of the
    same layout): logits over the padded vocab (``x @ w.T``)."""
    return x @ params["w"].T


def rotary(x: torch.Tensor, positions: torch.Tensor,
           theta: float) -> torch.Tensor:
    """Rotary embedding, computed in f32 and cast back to x.dtype.

    x: (..., seq, n_heads, head_dim); positions broadcastable to
    (..., seq).
    """
    head_dim = x.shape[-1]
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot1 = x1 * cos - x2 * sin
    rot2 = x2 * cos + x1 * sin
    out = torch.cat([rot1, rot2, x[..., 2 * half:]], dim=-1)
    return out.to(x.dtype)


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``, each product
    through ``qdot`` (packed weights take the quant-matmul kernel)."""
    g = qdot(x, params["w_gate"])
    u = qdot(x, params["w_up"])
    return qdot(torch.nn.functional.silu(g) * u, params["w_down"])
