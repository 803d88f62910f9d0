"""RMSNorm: the CUDA kernel's wrapper and its plain PyTorch version.

Port of ``repro/kernels/rmsnorm.py::rmsnorm_pallas``; the kernel is
``csrc/rmsnorm.cu`` (one block per row, f32 reduction).  The wrapper
runs the plain version for CPU tensors only; for a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last dim, in f32,
    cast back to ``x.dtype`` (``repro/models/layers.py::rmsnorm``)."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of ``x`` (..., d) with ``scale`` (d,); output in x.dtype."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    d = x.shape[-1]
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, scale on "
                         f"{scale.device}; the kernel needs both on one "
                         f"CUDA device")
    if scale.shape != (d,) or scale.dtype != x.dtype:
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} "
                         f"{scale.dtype} does not match x (..., {d}) "
                         f"{x.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: the kernel takes contiguous tensors")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    lib = _build.library()
    _build.launches["rmsnorm"] += 1
    _build.check(lib.rt_rmsnorm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
        float(eps), _build.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream), "rmsnorm")
    return out
