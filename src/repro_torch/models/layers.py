"""Shared building blocks: norms, embeddings, rotary, MLPs.

Port of ``repro/models/layers.py``.  Functions take parameter dicts of
tensors in the reference's layout (projection weights ``(in, out)``, so
``x @ w``, or packed quant leaves, see ``models/quantize.py``); inits
take an explicit :class:`torch.Generator`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.rmsnorm import add_rmsnorm as add_rmsnorm_kernel
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.models.quantize import qdot
from repro_torch.sharding.specs import (constrain, is_dtensor,
                                        keep_placements, local_call,
                                        replicated)


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
    """``layers.rmsnorm`` through the RMSNorm kernel's wrapper (a
    DTensor's rows on each rank, the normed dim whole)."""
    if is_dtensor(x):
        pl = keep_placements(x, (-1,))
        return local_call(lambda a, s: rmsnorm_kernel(a, s, eps),
                          (x, params["scale"]),
                          (pl, replicated(params["scale"])), pl)
    return rmsnorm_kernel(x, params["scale"], eps)


def add_rmsnorm(params: dict, x: torch.Tensor, delta: torch.Tensor,
                eps: float = 1e-5):
    """The residual add ``x + delta`` and ``layers.rmsnorm`` of its
    result, in one launch of the RMSNorm kernel.  Returns (x + delta,
    the normed row)."""
    if is_dtensor(x):
        pl = keep_placements(x, (-1,))
        return local_call(lambda a, d, s: add_rmsnorm_kernel(a, d, s, eps),
                          (x, delta, params["scale"]),
                          (pl, pl, replicated(params["scale"])), [pl, pl])
    return add_rmsnorm_kernel(x, delta, params["scale"], eps)


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table: a gather, whose gradient (train mode) sums each
    row's contributions in f32 on the card where an indexing gradient
    would add them into a bf16 table one by one."""
    return constrain(torch.nn.functional.embedding(tokens.long(),
                                                   params["w"]), "act_btd")


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """LM head (the tied embedding table or an untied ``lm_head`` of the
    same layout): logits over the padded vocab (``x @ w.T``)."""
    return constrain(x @ params["w"].T, "act_btv")


@functools.lru_cache(maxsize=64)
def _rotary_freq(theta: float, half: int,
                 device: torch.device) -> torch.Tensor:
    """``theta ** (-arange(half) / half)`` as the reference forms it: the
    exponent in f32, the power taken in f64 and rounded to f32.  An f32
    ``pow`` is an ulp off XLA's at a few entries of every served head
    size; this form equals it there, at qwen2-72b's theta 1e6 and
    command-r-35b's 8e6 too (tests/test_torch_spec.py).  Made once per
    (theta, half, device), outside inference mode so that training may
    read it, and never written to; a real tensor even under a fake mode
    (the dry-run's), which takes real inputs beside its fakes, so that
    the cache never holds a fake one."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with torch.inference_mode(False), unset_fake_temporarily():
        exponent = -torch.arange(0, half, dtype=torch.float32) / half
        freq = (theta ** exponent.double()).to(torch.float32)
        return freq.to(device)


def rotary(x: torch.Tensor, positions: torch.Tensor,
           theta: float) -> torch.Tensor:
    """Rotary embedding, computed in f32 and cast back to x.dtype.

    x: (..., seq, n_heads, head_dim); positions broadcastable to
    (..., seq).
    """
    head_dim = x.shape[-1]
    half = head_dim // 2
    freq = _rotary_freq(float(theta), half, x.device)
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
    h = constrain(torch.nn.functional.silu(g) * u, "act_btf")
    return qdot(h, params["w_down"])
