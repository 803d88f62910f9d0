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

Training runs the scan through :class:`SelectiveScanFn`, whose gradient
is a second kernel of the same source (``rt_selective_scan_backward``;
the JAX package has no backward kernel: ``jax.grad`` differentiates its
``lax.scan``).  Its forward launches the ``state_lanes`` body with a
buffer of **checkpoints**: the state before every
:data:`SCAN_CKPT_STEPS` steps; the backward walks those chunks in
reverse, recomputes each chunk's states from its checkpoint and steps
the state gradient back through them
(:func:`selective_scan_backward`, plain version
:func:`selective_scan_backward_plain`).  Serving passes no checkpoint
buffer, and its launches are the code they were.

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

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, fake

MAX_STATE = 64          # d_state the kernel keeps in registers
#: the d_state values the previous body (``cuda_core``) was built for
CUDA_CORE_STATES = frozenset(range(1, 17)) | {64}
SM_COUNT = 132          # H100 SXM
SCAN_LANES = (4, 8, 16)   # csrc/selective_scan.cu: G
SCAN_THREADS = 128        # kLanesThreads: 128 / G channels a block
#: states a lane holds at most above d_state 16 (where fewer lanes than
#: that would hold more states each)
LANE_STATES = 4
#: steps between two checkpoints of the state (csrc/selective_scan.cu:
#: kLanesTileT, the forward's staged tile, and kCkptSteps)
SCAN_CKPT_STEPS = 32
#: the backward kernel: states a lane, threads a block (csrc/
#: selective_scan.cu: kBwdS, kBwdThreads)
BWD_LANE_STATES = 4
BWD_THREADS = 256


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


def scan_checkpoints(t: int) -> int:
    """Checkpoints of a scan of ``t`` steps: the state before step 0,
    :data:`SCAN_CKPT_STEPS`, 2 :data:`SCAN_CKPT_STEPS`, ..."""
    return max(1, -(-t // SCAN_CKPT_STEPS))


def selective_scan_plain(dt, b_mat, c_mat, x, a_neg, h0,
                         h_out: Optional[torch.Tensor] = None,
                         checkpoints: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x: (B,T,DI); b_mat, c_mat: (B,T,DS); a_neg: (DI,DS);
    h0: (B,DI,DS).  Returns (y (B,T,DI), h_T (B,DI,DS) f32), stepping
    ``_mamba1_scan_step``'s ops in its order; ``h_T`` is written into
    ``h_out`` when given (which may be ``h0``), and the state before
    every :data:`SCAN_CKPT_STEPS` steps into ``checkpoints`` (B,
    :func:`scan_checkpoints`, DI, DS) when given."""
    h = h0.to(torch.float32)
    ys = []
    for t in range(dt.shape[1]):
        if checkpoints is not None and t % SCAN_CKPT_STEPS == 0:
            checkpoints[:, t // SCAN_CKPT_STEPS] = h
        dt_t, x_t = dt[:, t], x[:, t]
        decay = torch.exp(dt_t[..., None] * a_neg[None])
        incr = (dt_t * x_t)[..., None] * b_mat[:, t, None, :]
        h = decay * h + incr
        ys.append(torch.einsum("bds,bs->bd", h, c_mat[:, t]))
    y = torch.stack(ys, dim=1) if ys else dt.new_zeros(dt.shape)
    if checkpoints is not None and not ys:
        checkpoints[:, 0] = h
    if h_out is None:
        return y, h
    h_out.copy_(h)
    return y, h_out


def selective_scan(dt, b_mat, c_mat, x, a_neg, h0,
                   h_out: Optional[torch.Tensor] = None,
                   _body: Optional[str] = None,
                   checkpoints: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan of ``selective_scan_plain``'s signature; on the
    card every tensor is float32, ``dt``, ``x``, ``a_neg``, ``h0``,
    ``h_out`` and ``checkpoints`` contiguous, and d_state at most 64.
    ``checkpoints`` (the ``state_lanes`` body only) takes the state before
    every :data:`SCAN_CKPT_STEPS` steps, for :func:`selective_scan_backward`.
    ``_body`` forces a kernel body over :func:`scan_body`'s choice, for
    timing the bodies against each other; the model never passes it."""
    if fake.is_abstract(dt):
        y, h_t = fake.scan(dt, b_mat, c_mat, x, a_neg, h0)
        return y, (h_t if h_out is None else h_out)
    if dt.device.type == "cpu":
        return selective_scan_plain(dt, b_mat, c_mat, x, a_neg, h0, h_out,
                                    checkpoints)
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
    if body == "cuda_core" and checkpoints is not None:
        raise ValueError("selective_scan: only the state_lanes body writes "
                         "checkpoints")
    if h_out is None:
        h_out = torch.empty_like(h0)
    named = {"dt": dt, "b_mat": b_mat, "c_mat": c_mat, "x": x,
             "a_neg": a_neg, "h0": h0, "h_out": h_out}
    if checkpoints is not None:
        named["checkpoints"] = checkpoints
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
            or h0.shape != (bsz, di, ds) or h_out.shape != h0.shape
            or (checkpoints is not None and checkpoints.shape
                != (bsz, scan_checkpoints(t), di, ds))):
        raise ValueError(f"selective_scan: shapes "
                         f"{ {k: tuple(v.shape) for k, v in named.items()} }"
                         f" do not fit dt (B, T, DI) = {(bsz, t, di)}, "
                         f"d_state {ds}")
    lanes = scan_lanes(bsz, di, ds) if body == "state_lanes" else 1
    if not all(v.is_contiguous() for k, v in named.items()
               if k not in ("b_mat", "c_mat")):
        raise ValueError("selective_scan: dt, x, a_neg, h0, h_out and "
                         "checkpoints must be contiguous")
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
        None if checkpoints is None else checkpoints.data_ptr(),
        bsz, t, di, ds, b_mat.stride(0), b_mat.stride(1),
        _build.BODY_CODES[body], lanes,
        torch.cuda.current_stream(dt.device).cuda_stream), "selective_scan")
    return y, h_out


def bwd_lanes(ds: int) -> int:
    """Lanes G a channel of the backward kernel: the fewest of 1, 2, 4, 8
    and 16 that hold d_state in :data:`BWD_LANE_STATES` states a lane
    (falcon-mamba-7b's d_state 16: G 4; zamba2-7b's 64: G 16)."""
    scan_body(ds)                 # refuses a d_state outside 1..64
    return next(g for g in (1, 2, 4, 8, 16) if g * BWD_LANE_STATES >= ds)


def bwd_blocks(di: int, ds: int) -> int:
    """Blocks of the backward grid along a row: :data:`BWD_THREADS` / G
    channels each (16 at zamba2-7b's d_state 64, 64 at falcon-mamba-7b's
    16); each writes one partial of dB and dC a step."""
    return -(-di // (BWD_THREADS // bwd_lanes(ds)))


def bwd_occupancy(ds: int) -> tuple:
    """(blocks an SM of this card holds, dynamic shared memory) of the
    backward kernel at d_state ``ds``'s lanes, from the occupancy
    calculator on the kernel itself (card only)."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_build.library().rt_selective_scan_backward_occupancy(
        bwd_lanes(ds), ctypes.byref(blocks), ctypes.byref(smem)),
        "selective_scan_backward occupancy")
    return blocks.value, smem.value


def selective_scan_backward_plain(dt, b_mat, c_mat, x, a_neg, checkpoints,
                                  dy, dh_t=None):
    """Gradients of :func:`selective_scan_plain`'s (y, h_T) in torch ops,
    the kernel's algebra step by step.  With ``a_t = exp(dt_t·A)`` for
    each (row, channel, state), the state gradient runs back from ``g =
    dh_T`` (zero when None): ``g_t = C_t·dy_t + a_{t+1}·g_{t+1}``; then
    ``dx_t = dt_t·Σ_s g_t·B_t``, ``d(dt)_t = Σ_s g_t·(h_{t-1}·a_t·A +
    x_t·B_t)``, ``dB_t = Σ_d g_t·dt_t·x_t``, ``dC_t = Σ_d h_t·dy_t``,
    ``dA = Σ_{b,t} g_t·h_{t-1}·a_t·dt_t`` and ``dh0 = a_0·g_0``.  The
    states come chunk by chunk in reverse, each chunk's recomputed in
    float32 from its checkpoint (``checkpoints``, as
    :func:`selective_scan_plain` writes them) with the forward's
    operations; the gradient algebra runs in float64 on those states and
    decays, as the kernel's does (each gradient sums terms that cancel),
    and each gradient is rounded to float32 once.  Returns (d_dt, dB, dC,
    dx, dA, dh0), dB / dC contiguous (B,T,DS)."""
    bsz, t, di = dt.shape
    ds = a_neg.shape[-1]
    f64 = dict(dtype=torch.float64, device=dt.device)
    g_next = (torch.zeros((bsz, di, ds), **f64) if dh_t is None
              else dh_t.to(torch.float64))
    d_dt, dx = torch.empty((bsz, t, di), **f64), torch.empty((bsz, t, di),
                                                             **f64)
    db, dc = torch.empty((bsz, t, ds), **f64), torch.empty((bsz, t, ds),
                                                           **f64)
    da = torch.zeros((bsz, di, ds), **f64)
    a64 = a_neg.double()
    for c in reversed(range(scan_checkpoints(t))):
        t0 = c * SCAN_CKPT_STEPS
        h = checkpoints[:, c]
        hs, decays = [h], []
        for tt in range(t0, min(t, t0 + SCAN_CKPT_STEPS)):
            decay = torch.exp(dt[:, tt, :, None] * a_neg[None])
            h = decay * h + (dt[:, tt] * x[:, tt])[..., None] * b_mat[:, tt,
                                                                     None, :]
            hs.append(h)
            decays.append(decay)
        for i in reversed(range(len(decays))):
            tt = t0 + i
            dt_t, x_t, dy_t = (v[:, tt].double() for v in (dt, x, dy))
            b_t = b_mat[:, tt, None, :].double()
            c_t = c_mat[:, tt, None, :].double()
            decay, h_prev = decays[i].double(), hs[i].double()
            g = c_t * dy_t[..., None] + g_next
            dx[:, tt] = dt_t * (g * b_t).sum(-1)
            d_dt[:, tt] = (g * (h_prev * decay * a64
                                + x_t[..., None] * b_t)).sum(-1)
            db[:, tt] = (g * (dt_t * x_t)[..., None]).sum(1)
            dc[:, tt] = (hs[i + 1].double() * dy_t[..., None]).sum(1)
            da += g * h_prev * decay * dt_t[..., None]
            g_next = decay * g
    return tuple(v.to(torch.float32) for v in (d_dt, db, dc, dx, da.sum(0),
                                               g_next))


def selective_scan_backward(dt, b_mat, c_mat, x, a_neg, checkpoints, dy,
                            dh_t=None):
    """The scan's gradient: :func:`selective_scan_backward_plain`'s
    contract.  For a CPU tensor it runs the plain version; on the card it
    launches ``rt_selective_scan_backward`` (float32, d_state 1..64,
    ``dt``, ``x``, ``a_neg``, ``checkpoints``, ``dy`` and ``dh_t``
    contiguous, B and C with a unit d_state stride and the forward's
    strides) or raises.  The kernel adds no atomics: dB and dC are summed
    over a row's blocks, and dA over the rows, in a fixed order, so the
    same inputs give the same bits."""
    if fake.is_abstract(dt):
        return fake.scan_backward(dt, b_mat, c_mat, x, a_neg, checkpoints,
                                  dy)
    if dt.device.type == "cpu":
        return selective_scan_backward_plain(dt, b_mat, c_mat, x, a_neg,
                                             checkpoints, dy, dh_t)
    bsz, t, di = dt.shape
    ds = a_neg.shape[-1]
    lanes = bwd_lanes(ds)
    nblk = bwd_blocks(di, ds)
    named = {"dt": dt, "b_mat": b_mat, "c_mat": c_mat, "x": x,
             "a_neg": a_neg, "checkpoints": checkpoints, "dy": dy}
    if dh_t is not None:
        named["dh_t"] = dh_t
    if dt.device.type != "cuda" or any(v.device != dt.device
                                       for v in named.values()):
        raise ValueError(f"selective_scan_backward: tensors on "
                         f"{sorted({str(v.device) for v in named.values()})};"
                         f" the kernel needs them on one CUDA device")
    if any(v.dtype != torch.float32 for v in named.values()):
        raise ValueError(f"selective_scan_backward: the kernel takes "
                         f"float32, got "
                         f"{ {k: str(v.dtype) for k, v in named.items()} }")
    if (x.shape != dt.shape or dy.shape != dt.shape
            or b_mat.shape != (bsz, t, ds) or c_mat.shape != b_mat.shape
            or a_neg.shape != (di, ds)
            or checkpoints.shape != (bsz, scan_checkpoints(t), di, ds)
            or (dh_t is not None and dh_t.shape != (bsz, di, ds))):
        raise ValueError(f"selective_scan_backward: shapes "
                         f"{ {k: tuple(v.shape) for k, v in named.items()} }"
                         f" do not fit dt (B, T, DI) = {(bsz, t, di)}, "
                         f"d_state {ds}")
    if not all(v.is_contiguous() for k, v in named.items()
               if k not in ("b_mat", "c_mat")):
        raise ValueError("selective_scan_backward: dt, x, a_neg, "
                         "checkpoints, dy and dh_t must be contiguous")
    if (b_mat.stride() != c_mat.stride()
            or (ds > 1 and b_mat.stride(2) != 1)):
        raise ValueError(f"selective_scan_backward: b_mat / c_mat strides "
                         f"{b_mat.stride()} / {c_mat.stride()}; the kernel "
                         f"needs equal strides and a unit d_state stride")
    f32 = dict(dtype=torch.float32, device=dt.device)
    d_dt, dx = torch.empty_like(dt), torch.empty_like(dt)
    db, dc = torch.empty((bsz, t, ds), **f32), torch.empty((bsz, t, ds),
                                                           **f32)
    da, dh0 = torch.empty((di, ds), **f32), torch.empty((bsz, di, ds), **f32)
    # one partial of dB and dC a block and step, and of dA a row, in
    # double (the kernel's gradient algebra runs in double)
    f64 = dict(dtype=torch.float64, device=dt.device)
    part_b = torch.empty((bsz, nblk, t, ds), **f64)
    part_c = torch.empty_like(part_b)
    part_a = torch.empty((bsz, di, ds), **f64)
    lib = _build.library()
    _build.launches["selective_scan_backward"] += 1
    _build.check(lib.rt_selective_scan_backward(
        dt.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(), x.data_ptr(),
        a_neg.data_ptr(), checkpoints.data_ptr(), dy.data_ptr(),
        None if dh_t is None else dh_t.data_ptr(),
        d_dt.data_ptr(), db.data_ptr(), dc.data_ptr(), dx.data_ptr(),
        da.data_ptr(), dh0.data_ptr(), part_b.data_ptr(), part_c.data_ptr(),
        part_a.data_ptr(), bsz, t, di, ds, b_mat.stride(0), b_mat.stride(1),
        lanes, nblk, torch.cuda.current_stream(dt.device).cuda_stream),
        "selective_scan_backward")
    return d_dt, db, dc, dx, da, dh0


class SelectiveScanFn(torch.autograd.Function):
    """:func:`selective_scan` with a gradient.  ``apply(dt, b_mat, c_mat,
    x, a_neg, h0)`` returns (y, h_T) from a fresh state (``h0`` is read,
    never written: autograd refuses an in-place write of a saved
    tensor).  The forward is the kernel with checkpoints on a CUDA tensor
    and the plain version on a CPU one (the wrapper's rule); it saves
    the inputs and the checkpoints, and the backward is
    :func:`selective_scan_backward` (the backward kernel on the card)
    under the profiler label ``selective_scan_backward``."""

    @staticmethod
    def forward(ctx, dt, b_mat, c_mat, x, a_neg, h0):
        bsz, t, di = dt.shape
        ckpt = torch.empty((bsz, scan_checkpoints(t), di, a_neg.shape[-1]),
                           dtype=torch.float32, device=dt.device)
        y, h_t = selective_scan(dt, b_mat, c_mat, x, a_neg, h0,
                                checkpoints=ckpt)
        ctx.save_for_backward(dt, b_mat, c_mat, x, a_neg, ckpt)
        return y, h_t

    @staticmethod
    def backward(ctx, dy, dh_t):
        dt, b_mat, c_mat, x, a_neg, ckpt = ctx.saved_tensors
        with torch.profiler.record_function("selective_scan_backward"):
            grads = selective_scan_backward(
                dt, b_mat, c_mat, x, a_neg, ckpt, dy.contiguous(),
                None if dh_t is None else dh_t.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
