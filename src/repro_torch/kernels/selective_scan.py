"""The selective scan: the CUDA kernel's wrapper and its plain PyTorch
version.

Port of ``repro/kernels/selective_scan.py::selective_scan_pallas``: the
recurrence ``h = exp(dt·A)·h + (dt·x)⊗B``, ``y_t = Σ_s h·C_t`` over T
steps in float32, the reference model's ``_mamba1_scan_step`` scanned
over a prefill chunk (``models/ssm.py::mamba1_seq``) or taken once for
a decode step (``mamba1_step``, T = 1); Mamba2's recurrence runs through
it too, its per-head dt and A expanded over the channels
(``models/ssm.py::_mamba2_scan``).  The kernel is
``csrc/selective_scan.cu``, with two bodies:

* ``"state_lanes"`` (every launch the model makes; :func:`scan_body`;
  d_state 1 to 64):
  each (row, channel)'s d_state values split across G lanes of a warp
  (:func:`scan_lanes` picks G from 4, 8 and 16 so every SM has a
  block), the
  state in registers across the T steps, its loads and stores whole
  contiguous segments, y summed across the lanes by warp shuffles.
* ``"cuda_core"`` (the previous body, kept to be timed against it;
  d_state 1 to 16 and 64): one thread per (row, channel) with all its
  d_state values.

Both update each state element with the same operations in the same
order, so their ``h_T`` are bit-equal; y may differ in its last bits
(the sum over d_state runs in another order).

The state is **updated in place** when the caller passes ``h_out=h0``
(the model hands in its cache row): the kernel reads each channel's
state before the first step and writes it after the last.  ``b_mat``
and ``c_mat`` may be column slices of a wider tensor (the model's
``x_proj`` output in a float32 model): the kernel takes their batch and
time strides and needs only a unit stride along d_state.  The wrapper
runs the plain version for CPU tensors only; for a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

MAX_STATE = 64          # d_state the kernel keeps in registers
#: the d_state values the previous body (``cuda_core``) was built for
CUDA_CORE_STATES = frozenset(range(1, 17)) | {64}
SM_COUNT = 132          # H100 SXM
SCAN_LANES = (4, 8, 16)   # csrc/selective_scan.cu: G
SCAN_THREADS = 128        # kLanesThreads: 128 / G channels a block
#: states a lane holds at most above d_state 16 (where fewer lanes than
#: that would hold more states each)
LANE_STATES = 4


def scan_body(ds: int) -> str:
    """The scan body a launch takes: ``"state_lanes"`` for every d_state
    the kernel holds (1..64); any other d_state is refused."""
    if not 1 <= ds <= MAX_STATE:
        raise ValueError(f"selective_scan: d_state {ds} outside "
                         f"1..{MAX_STATE}")
    return "state_lanes"


def scan_blocks(b: int, di: int, g: int) -> int:
    """Blocks of the ``state_lanes`` grid at G lanes a channel."""
    return b * -(-di // (SCAN_THREADS // g))


def scan_lanes(b: int, di: int, ds: int) -> int:
    """Lanes G per (row, channel) for the ``state_lanes`` body: the
    fewest of 4, 8 and 16 that still give every SM a block, else the
    most; G never exceeds d_state rounded up to a power of two, so no
    lane group sits wholly idle.  Fewer lanes hold more states each,
    which takes fewer instructions per state (dt, x, B and C loaded once
    for S states, one y share per lane) and wider state loads: at
    falcon-mamba-7b's shapes G 4 is the fastest at decode (1, 4 and 8
    rows) and over a chunk (tools/torch_scan_sweep.py).  Above d_state
    16 that trade turns: a lane of 16 states holds h, A, B and C in 64
    registers and its tile's y shares besides, so there G is the fewest
    lanes that hold at most ``LANE_STATES`` states each (zamba2-7b's
    d_state 64: G 16, about twice as fast as G 4 at decode and 1.2x over
    a chunk, tools/torch_scan_sweep.py).  Shapes only, so the same
    shapes give the same bits."""
    cap = max(SCAN_LANES[0], 1 << (max(ds, 1) - 1).bit_length())
    fits = [g for g in SCAN_LANES if g <= cap]
    if ds > 16:
        return next((g for g in fits if -(-ds // g) <= LANE_STATES),
                    fits[-1])
    return next((g for g in fits if scan_blocks(b, di, g) >= SM_COUNT),
                fits[-1])


def selective_scan_plain(dt, b_mat, c_mat, x, a_neg, h0,
                         h_out: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x: (B,T,DI); b_mat, c_mat: (B,T,DS); a_neg: (DI,DS);
    h0: (B,DI,DS).  Returns (y (B,T,DI), h_T (B,DI,DS) f32), stepping
    ``_mamba1_scan_step``'s ops in its order; ``h_T`` is written into
    ``h_out`` when given (which may be ``h0``)."""
    h = h0.to(torch.float32)
    ys = []
    for t in range(dt.shape[1]):
        dt_t, x_t = dt[:, t], x[:, t]
        decay = torch.exp(dt_t[..., None] * a_neg[None])
        incr = (dt_t * x_t)[..., None] * b_mat[:, t, None, :]
        h = decay * h + incr
        ys.append(torch.einsum("bds,bs->bd", h, c_mat[:, t]))
    y = torch.stack(ys, dim=1) if ys else dt.new_zeros(dt.shape)
    if h_out is None:
        return y, h
    h_out.copy_(h)
    return y, h_out


def selective_scan(dt, b_mat, c_mat, x, a_neg, h0,
                   h_out: Optional[torch.Tensor] = None,
                   _body: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan of ``selective_scan_plain``'s signature; on the
    card every tensor is float32, ``dt``, ``x``, ``a_neg``, ``h0`` and
    ``h_out`` contiguous, and d_state at most 64.  ``_body`` forces a
    kernel body over :func:`scan_body`'s choice, for timing the bodies
    against each other; the model never passes it."""
    if dt.device.type == "cpu":
        return selective_scan_plain(dt, b_mat, c_mat, x, a_neg, h0, h_out)
    bsz, t, di = dt.shape
    ds = a_neg.shape[-1]
    default = scan_body(ds)       # refuses a d_state outside 1..64
    body = _body or default
    if body not in _build.bodies["selective_scan"]:
        raise ValueError(f"selective_scan: no kernel body {body!r}; the "
                         f"bodies are {sorted(_build.bodies['selective_scan'])}")
    if body == "cuda_core" and ds not in CUDA_CORE_STATES:
        raise ValueError(f"selective_scan: the cuda_core body takes d_state "
                         f"1..16 and 64, not {ds}")
    if h_out is None:
        h_out = torch.empty_like(h0)
    named = {"dt": dt, "b_mat": b_mat, "c_mat": c_mat, "x": x,
             "a_neg": a_neg, "h0": h0, "h_out": h_out}
    if dt.device.type != "cuda" or any(v.device != dt.device
                                       for v in named.values()):
        raise ValueError(f"selective_scan: tensors on "
                         f"{sorted({str(v.device) for v in named.values()})};"
                         f" the kernel needs them on one CUDA device")
    if any(v.dtype != torch.float32 for v in named.values()):
        raise ValueError(f"selective_scan: the kernel takes float32, got "
                         f"{ {k: str(v.dtype) for k, v in named.items()} }")
    if (x.shape != dt.shape or b_mat.shape != (bsz, t, ds)
            or c_mat.shape != b_mat.shape or a_neg.shape != (di, ds)
            or h0.shape != (bsz, di, ds) or h_out.shape != h0.shape):
        raise ValueError(f"selective_scan: shapes "
                         f"{ {k: tuple(v.shape) for k, v in named.items()} }"
                         f" do not fit dt (B, T, DI) = {(bsz, t, di)}, "
                         f"d_state {ds}")
    lanes = scan_lanes(bsz, di, ds) if body == "state_lanes" else 1
    if not all(v.is_contiguous() for v in (dt, x, a_neg, h0, h_out)):
        raise ValueError("selective_scan: dt, x, a_neg, h0 and h_out must "
                         "be contiguous")
    if (b_mat.stride() != c_mat.stride()
            or (ds > 1 and b_mat.stride(2) != 1)):
        raise ValueError(f"selective_scan: b_mat / c_mat strides "
                         f"{b_mat.stride()} / {c_mat.stride()}; the kernel "
                         f"needs equal strides and a unit d_state stride")
    y = torch.empty_like(dt)
    lib = _build.library()
    _build.launches["selective_scan"] += 1
    _build.bodies["selective_scan"][body] += 1
    _build.check(lib.rt_selective_scan(
        dt.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(), x.data_ptr(),
        a_neg.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
        bsz, t, di, ds, b_mat.stride(0), b_mat.stride(1),
        _build.BODY_CODES[body], lanes,
        torch.cuda.current_stream(dt.device).cuda_stream), "selective_scan")
    return y, h_out
