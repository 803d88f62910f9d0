"""RMSNorm, alone or fused with the residual add before it: the CUDA
kernel's wrapper and its plain PyTorch version.

Port of ``repro/kernels/rmsnorm.py::rmsnorm_pallas``: :func:`rmsnorm`
computes exactly its function.  :func:`add_rmsnorm` computes the
residual add the reference model runs before a norm (``x + a``) and the
norm of its result in one launch: ``r = x + delta``, rounded once to
x's dtype as torch's add rounds it, and ``out = rmsnorm(r)``.  The
kernel is ``csrc/rmsnorm.cu``, with three bodies:

* ``"add_norm"`` / ``"norm"`` (every launch the model makes:
  :func:`add_rmsnorm` takes the first, :func:`rmsnorm` the second):
  each row in the registers of up to 8 warps of
  one block, one 16-byte access a lane where the row allows
  (:func:`norm_lanes`), every load issued before the reduction.
* ``"cuda_core"`` (the previous body, kept to be timed against them):
  one block per row, the row read twice.  Through ``add_rmsnorm`` it is
  the previous composition: torch's add, then that norm.

The wrapper runs the plain version for CPU tensors only; for a CUDA
tensor it launches the kernel or raises.

Both wrappers have a gradient (:class:`RmsNormFn`,
:class:`AddRmsNormFn`: the forward is the same launch, the backward
torch ops that recompute the row's ``rsqrt`` in f32), taken only when
grad mode is on and an input requires grad; every other call, the
serving path's among them, launches as it did, with no autograd node.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, fake

SM_COUNT = 132            # H100 SXM
NORM_MAX_WARPS = 8        # csrc/rmsnorm.cu: kMaxWarps, warps a block
NORM_VECS = (1, 2, 4, 8, 16)   # accesses a lane per tensor
NORM_ROWS_PER_BLOCK = (8, 4, 2, 1)


def norm_pack(dtype: torch.dtype, d: int, aligned: bool = True) -> int:
    """Elements per access: one 16-byte vector when the tensors are
    16-byte aligned and a row is a whole number of vectors, else one
    element."""
    vec = 16 // (torch.finfo(dtype).bits // 8)
    return vec if aligned and d % vec == 0 else 1


def norm_lanes(rows: int, d: int, pack: int) -> Tuple[int, int, int]:
    """(lanes a row, rows a block, accesses a lane per tensor) for the
    ``add_norm`` / ``norm`` bodies.  One access a lane, in as many warps
    as that takes (a power of two) up to 8 a row; a wider row takes more
    accesses a lane (a power of two, at most 16).  Rows that fit one warp
    group into blocks of up to 8, the most that still give every SM a
    block.  At the main path's shapes this was the fastest launch shape
    in bf16 and within 6% of it in float32 (tools/torch_norm_sweep.py);
    one warp holding a whole row of 4096 bf16 values took twice the
    time.  Shapes only, so the same shapes give the same bits."""
    n_acc = -(-d // pack)
    warps = 1
    while warps < NORM_MAX_WARPS and 32 * warps < n_acc:
        warps *= 2
    per = -(-n_acc // (32 * warps))
    vecs = next((v for v in NORM_VECS if v >= per), None)
    if vecs is None:
        raise ValueError(f"rmsnorm: a row of {d} elements ({n_acc} "
                         f"accesses) is wider than one block of "
                         f"{NORM_MAX_WARPS} warps holds")
    rows_per_block = 1 if warps > 1 else next(
        (r for r in NORM_ROWS_PER_BLOCK if -(-rows // r) >= SM_COUNT), 1)
    return 32 * warps, rows_per_block, vecs


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last dim, in f32,
    cast back to ``x.dtype`` (``repro/models/layers.py::rmsnorm``)."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def add_rmsnorm_plain(x: torch.Tensor, delta: torch.Tensor,
                      scale: torch.Tensor, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``r = x + delta``, then ``rmsnorm_plain(r)``: the reference
    model's residual add and the norm after it.  Returns (r, out)."""
    r = x + delta
    return r, rmsnorm_plain(r, scale, eps)


def _launch(x: torch.Tensor, delta: Optional[torch.Tensor],
            scale: torch.Tensor, eps: float, body: str, name: str
            ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Check the tensors and launch ``body``; (r or None, out)."""
    d = x.shape[-1]
    if delta is not None and (delta.shape != x.shape
                              or delta.dtype != x.dtype
                              or delta.device != x.device):
        raise ValueError(f"{name}: delta {tuple(delta.shape)} {delta.dtype} "
                         f"on {delta.device} does not match x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if scale.shape != (d,) or scale.dtype != x.dtype:
        raise ValueError(f"{name}: scale {tuple(scale.shape)} "
                         f"{scale.dtype} does not match x (..., {d}) "
                         f"{x.dtype}")
    tensors = [a for a in (x, delta, scale) if a is not None]
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, scale on "
                         f"{scale.device}; the kernel needs both on one "
                         f"CUDA device")
    code = _build.dtype_code(x.dtype)
    rows = x.numel() // d if d else 0
    # outputs come from the allocator, 16-byte aligned
    pack = norm_pack(x.dtype, d,
                     all(a.data_ptr() % 16 == 0 for a in tensors))
    lanes, rows_per_block, vecs = (norm_lanes(rows, d, pack)
                                   if body != "cuda_core" else (0, 0, 0))
    out = torch.empty_like(x)
    r = torch.empty_like(x) if delta is not None else None
    lib = _build.library()
    _build.launches["rmsnorm"] += 1
    _build.bodies["rmsnorm"][body] += 1
    _build.check(lib.rt_rmsnorm(
        x.data_ptr(), None if delta is None else delta.data_ptr(),
        scale.data_ptr(), None if r is None else r.data_ptr(),
        out.data_ptr(), rows, d, float(eps), code, _build.BODY_CODES[body],
        int(pack > 1), lanes, rows_per_block, vecs,
        torch.cuda.current_stream(x.device).cuda_stream), name)
    return r, out


def _check_body(body: Optional[str], name: str) -> None:
    if body is not None and body not in _build.bodies["rmsnorm"]:
        raise ValueError(f"{name}: no kernel body {body!r}; the bodies "
                         f"are {sorted(_build.bodies['rmsnorm'])}")


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
            _body: Optional[str] = None) -> torch.Tensor:
    """RMSNorm of ``x`` (..., d) with ``scale`` (d,); output in x.dtype.
    ``_body="cuda_core"`` forces the previous body, for timing the bodies
    against each other; the model never passes it."""
    _check_body(_body, "rmsnorm")
    if _wants_grad(x, scale):
        return RmsNormFn.apply(x, scale, eps, _body)
    return _rmsnorm(x, scale, eps, _body)


def _rmsnorm(x, scale, eps, _body):
    if fake.is_abstract(x):
        return fake.rmsnorm(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    body = _body or "norm"
    if body == "add_norm":
        raise ValueError("rmsnorm: the add_norm body needs a delta; call "
                         "add_rmsnorm")
    return _launch(x, None, scale, eps, body, "rmsnorm")[1]


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5, _body: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(r, rmsnorm(r))`` with ``r = x + delta``, both (..., d) in one
    dtype, in one launch; ``r`` is a new tensor.  ``_body="cuda_core"``
    runs the previous composition instead (torch's add, then the previous
    norm body), for timing the two against each other; the model never
    passes it."""
    _check_body(_body, "add_rmsnorm")
    if _wants_grad(x, delta, scale):
        return AddRmsNormFn.apply(x, delta, scale, eps, _body)
    return _add_rmsnorm(x, delta, scale, eps, _body)


def _add_rmsnorm(x, delta, scale, eps, _body):
    if fake.is_abstract(x):
        return fake.add_rmsnorm(x, delta, scale)
    if x.device.type == "cpu":
        return add_rmsnorm_plain(x, delta, scale, eps)
    body = _body or "add_norm"
    if body == "norm":
        raise ValueError("add_rmsnorm: the norm body takes no delta; call "
                         "rmsnorm")
    if body == "cuda_core":
        if delta.shape != x.shape or delta.dtype != x.dtype:
            raise ValueError(f"add_rmsnorm: delta {tuple(delta.shape)} "
                             f"{delta.dtype} does not match x "
                             f"{tuple(x.shape)} {x.dtype}")
        r = x + delta
        return r, _rmsnorm(r, scale, eps, "cuda_core")
    return _launch(x, delta, scale, eps, body, "add_rmsnorm")


def rmsnorm_backward(r: torch.Tensor, scale: torch.Tensor, eps: float,
                     dout: torch.Tensor):
    """(dr, dscale) of ``out = rmsnorm(r)`` in f32, the row's ``rsqrt``
    recomputed from ``r``: with ``n = r * rsqrt(mean(r^2) + eps)``,
    ``dscale = sum(dout * n)`` over the rows and ``dr = rsqrt(...) *
    (g - n * mean(g * n))`` with ``g = dout * scale``."""
    r32 = r.float()
    inv = torch.rsqrt(torch.mean(r32 * r32, dim=-1, keepdim=True) + eps)
    n = r32 * inv
    g32 = dout.float()
    dscale = (g32 * n).reshape(-1, r.shape[-1]).sum(dim=0)
    g32 = g32 * scale.float()
    dr = inv * (g32 - n * torch.mean(g32 * n, dim=-1, keepdim=True))
    return dr, dscale


class RmsNormFn(torch.autograd.Function):
    """:func:`rmsnorm` with a gradient: the forward is the wrapper's
    launch (the plain version on a CPU tensor), the backward
    :func:`rmsnorm_backward`, each gradient in its input's dtype."""

    @staticmethod
    def forward(ctx, x, scale, eps=1e-5, body=None):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm(x, scale, eps, body)

    @staticmethod
    def backward(ctx, dout):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, ctx.eps, dout)
        return dx.to(x.dtype), dscale.to(scale.dtype), None, None


class AddRmsNormFn(torch.autograd.Function):
    """:func:`add_rmsnorm` with a gradient: the forward is the wrapper's
    one launch, returning ``(r, out)``; the backward adds ``out``'s
    gradient through the norm (:func:`rmsnorm_backward`, from the saved
    ``r``) to ``r``'s own, which is then the gradient of both x and
    delta."""

    @staticmethod
    def forward(ctx, x, delta, scale, eps=1e-5, body=None):
        r, out = _add_rmsnorm(x, delta, scale, eps, body)
        ctx.save_for_backward(r, scale)
        ctx.eps = eps
        return r, out

    @staticmethod
    def backward(ctx, dr, dout):
        r, scale = ctx.saved_tensors
        dnorm, dscale = rmsnorm_backward(r, scale, ctx.eps, dout)
        dsum = dnorm + dr.float()
        return (dsum.to(r.dtype), dsum.to(r.dtype), dscale.to(scale.dtype),
                None, None)
