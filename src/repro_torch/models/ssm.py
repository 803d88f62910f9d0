"""Mamba1 and Mamba2 blocks.

Port of ``repro/models/ssm.py`` for the serving modes: ``mamba1_seq``
/ ``mamba2_seq`` run a prefill chunk (resuming from a carried state),
``mamba1_step`` / ``mamba2_step`` one decode step.  All four run their
recurrence through the selective-scan kernel's wrapper
(``kernels/selective_scan.py``); a decode step is the scan at T = 1,
which computes exactly the reference's ``_mamba1_scan_step``.

Mamba2's recurrence (the reference's ``_mamba2_scan_step``: a scalar
``A`` and ``dt`` per head of ``mamba2_headdim`` channels, ``B`` and
``C`` shared by every head) is Mamba1's under two expansions, which
:func:`_mamba2_scan` makes before it calls the same kernel: ``dt``
repeated over each head's channels, and ``A`` over the channels and
d_state.  The decay ``exp(dt·a)``, the increment ``(dt·x)·B`` and
``y = Σ_s h·C`` are then the same operations on the same values; the
per-head ``D`` is expanded the same way.  Its state ``(B, nh, headdim,
d_state)`` is the kernel's ``(B, d_inner, d_state)`` viewed by head.

Where the reference returns new states, the port writes them **in
place** into the caller's ``h`` and ``conv`` tensors (the model's cache
rows) and returns those.  In train mode (``train=True``: a whole
sequence from zero state, as the reference's train forward runs
``mamba1_seq`` / ``mamba2_seq``) the scan runs through
:class:`~repro_torch.kernels.selective_scan.SelectiveScanFn`, whose
gradient is the backward kernel, on a fresh state that nothing writes in
place (autograd refuses an in-place write of a saved tensor).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import (SelectiveScanFn,
                                                selective_scan)
from repro_torch.models.layers import _dense_init

#: leaves the reference keeps in float32 whatever the model dtype
F32_LEAVES = frozenset({"A_log", "D"})
#: the same for a Mamba2 block, whose per-head ``dt_bias`` is float32 too
MAMBA2_F32_LEAVES = F32_LEAVES | {"dt_bias"}


def _causal_conv(x, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv. x: (B,T,C), conv_w: (W,C) -> (B,T,C).
    ``conv_state`` (B, W-1, C) carries the last inputs of a previous
    chunk; None is zeros (start of sequence).  The taps are summed as
    the reference sums them: a Python ``sum`` over W, then ``+ conv_b``."""
    w = conv_w.shape[0]
    if conv_state is None:
        pad = F.pad(x, (0, 0, w - 1, 0))
    else:
        pad = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = sum(pad[:, i:i + x.shape[1], :] * conv_w[i] for i in range(w))
    return out + conv_b


def _conv_step(conv_state, x_t, conv_w, conv_b):
    """conv_state: (B, W-1, C) past inputs; x_t: (B, C).  Returns
    (out (B, C), the next state (B, W-1, C)).  ``out`` is laid out
    row-major: on the card the einsum's batched product over C returns
    it transposed, and the scan kernel takes x contiguous."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B,W,C)
    out = torch.einsum("bwc,wc->bc", window, conv_w).contiguous() + conv_b
    return out, window[:, 1:, :]


def mamba1_init(generator, cfg, dtype, device, n: int) -> dict:
    """``n`` stacked Mamba1 layers (the reference's ``mamba1_init`` with
    a leading layer dim): ``A_log`` and ``D`` in float32, ``dt_bias`` at
    -2 in the model dtype."""
    d, di, ds = cfg.d_model, cfg.d_inner_eff, cfg.ssm_state
    dt_rank = max(1, d // 16)
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=device)).expand(n, di, ds)
    return {
        "in_proj": _dense_init(generator, (n, d, 2 * di), dtype, device),
        "conv_w": _dense_init(generator, (n, cfg.conv_width, di), dtype,
                              device, scale=0.5),
        "conv_b": torch.zeros((n, di), dtype=dtype, device=device),
        "x_proj": _dense_init(generator, (n, di, dt_rank + 2 * ds), dtype,
                              device),
        "dt_proj": _dense_init(generator, (n, dt_rank, di), dtype, device),
        "dt_bias": torch.full((n, di), -2.0, dtype=dtype, device=device),
        "A_log": a_log.contiguous(),
        "D": torch.ones((n, di), dtype=torch.float32, device=device),
        "out_proj": _dense_init(generator, (n, di, d), dtype, device),
    }


def _mamba1_inner(params, x_c, cfg):
    """Per-step SSM inputs from the conv output x_c (B,T,di): dt (the
    softplus in the model dtype, then float32), B and C (float32)."""
    ds = cfg.ssm_state
    dt_rank = max(1, cfg.d_model // 16)
    proj = x_c @ params["x_proj"]
    dt_r = proj[..., :dt_rank]
    b_mat = proj[..., dt_rank:dt_rank + ds].to(torch.float32)
    c_mat = proj[..., dt_rank + ds:].to(torch.float32)
    dt = F.softplus(dt_r @ params["dt_proj"]
                    + params["dt_bias"]).to(torch.float32)
    return dt, b_mat, c_mat


def _gate_out(params, y, x32, z, dtype, d_skip=None):
    """``(y + D·x) · silu(z)`` in float32, cast to the model dtype, then
    the output projection; ``d_skip`` replaces ``params["D"]`` (Mamba2's
    per-head D expanded over the channels)."""
    y = y + (params["D"] if d_skip is None else d_skip) * x32
    y = (y * F.silu(z.to(torch.float32))).to(dtype)
    return y @ params["out_proj"]


def mamba1_seq(params, x, cfg, h0=None, conv_state=None, train=False):
    """A chunk. x: (B,T,D) -> (out, (h_T, conv_state_T)).

    ``h0`` (B,di,ds) f32 and ``conv_state`` (B,W-1,di) resume the
    recurrence from a previous chunk and are updated in place; None
    means start-of-sequence zeros (fresh tensors are then returned).
    ``train``: from zero state, through :class:`SelectiveScanFn`."""
    b = x.shape[0]
    di, ds = cfg.d_inner_eff, cfg.ssm_state
    xz = x @ params["in_proj"]
    x_i, z = torch.split(xz, di, dim=-1)
    x_c = F.silu(_causal_conv(x_i, params["conv_w"], params["conv_b"],
                              conv_state))
    dt, b_mat, c_mat = _mamba1_inner(params, x_c, cfg)
    a_neg = -torch.exp(params["A_log"])
    x32 = x_c.to(torch.float32)
    if h0 is None:
        h0 = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    if train:
        y, h_t = SelectiveScanFn.apply(dt, b_mat, c_mat, x32, a_neg, h0)
    else:
        y, h_t = selective_scan(dt, b_mat, c_mat, x32, a_neg, h0, h_out=h0)
    out = _gate_out(params, y, x32, z, x.dtype)
    return out, (h_t, _next_conv_state(x_i, conv_state, cfg))


def _next_conv_state(x_i, conv_state, cfg):
    """Last W-1 SSM inputs after a chunk (the carried state prepended,
    so chunks shorter than the conv window still roll forward), written
    into ``conv_state`` when given."""
    w1 = cfg.conv_width - 1
    prev = (torch.zeros((x_i.shape[0], w1, x_i.shape[-1]), dtype=x_i.dtype,
                        device=x_i.device)
            if conv_state is None else conv_state.to(x_i.dtype))
    nxt = torch.cat([prev, x_i], dim=1)[:, -w1:, :]
    if conv_state is None:
        return nxt
    conv_state.copy_(nxt)
    return conv_state


def mamba1_step(params, x, state, cfg):
    """A decode step. x: (B,1,D); state = (h (B,di,ds) f32, conv
    (B,W-1,di)), both updated in place.  Returns (out (B,1,D), state)."""
    h, conv_state = state
    di = cfg.d_inner_eff
    xz = (x @ params["in_proj"])[:, 0]
    x_i, z = torch.split(xz, di, dim=-1)                   # (B, di)
    x_c, nxt = _conv_step(conv_state, x_i, params["conv_w"],
                          params["conv_b"])
    conv_state.copy_(nxt)
    x_c = F.silu(x_c)[:, None, :]                          # (B, 1, di)
    dt, b_mat, c_mat = _mamba1_inner(params, x_c, cfg)
    a_neg = -torch.exp(params["A_log"])
    x32 = x_c.to(torch.float32)
    y, h = selective_scan(dt, b_mat, c_mat, x32, a_neg, h, h_out=h)
    out = _gate_out(params, y, x32, z[:, None, :], x.dtype)
    return out, (h, conv_state)


# ----------------------------------------------------------------------
# Mamba 2 (SSD with scalar A per head)
# ----------------------------------------------------------------------
def mamba2_init(generator, cfg, dtype, device, n: int) -> dict:
    """``n`` stacked Mamba2 layers (the reference's ``mamba2_init`` with
    a leading layer dim): ``dt_bias`` (-2), ``A_log`` (0) and ``D`` (1)
    per head, in float32."""
    d, di, ds = cfg.d_model, cfg.d_inner_eff, cfg.ssm_state
    nh = max(1, di // cfg.mamba2_headdim)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _dense_init(generator, (n, d, 2 * di), dtype, device),
        "conv_w": _dense_init(generator, (n, cfg.conv_width, di), dtype,
                              device, scale=0.5),
        "conv_b": torch.zeros((n, di), dtype=dtype, device=device),
        "bc_proj": _dense_init(generator, (n, d, 2 * ds), dtype, device),
        "dt_w": _dense_init(generator, (n, d, nh), dtype, device),
        "dt_bias": torch.full((n, nh), -2.0, **f32),
        "A_log": torch.zeros((n, nh), **f32),
        "D": torch.ones((n, nh), **f32),
        "out_proj": _dense_init(generator, (n, di, d), dtype, device),
    }


def _mamba2_inner(params, x, cfg):
    """Per-step SSM inputs from the block input x (B,T,D): dt (B,T,nh)
    float32 (the softplus in float32), and B and C (B,T,ds) float32,
    column slices of one projection."""
    ds = cfg.ssm_state
    bc = (x @ params["bc_proj"]).to(torch.float32)
    dt = F.softplus((x @ params["dt_w"]).to(torch.float32)
                    + params["dt_bias"])
    return dt, bc[..., :ds], bc[..., ds:]


def _mamba2_scan(params, dt, b_mat, c_mat, x32, h, cfg, train=False):
    """The Mamba2 recurrence through the selective-scan kernel: dt
    (B,T,nh) repeated over each head's channels, ``-exp(A_log)`` over
    the channels and d_state, and the state ``h`` (B,nh,headdim,ds)
    viewed as (B,di,ds) and updated in place (``train``: read, not
    written, through :class:`SelectiveScanFn`, whose gradients of the
    expanded dt and A autograd sums back over each head's channels).
    Returns (y (B,T,di) f32, D expanded over the channels, h_T)."""
    hd, ds = cfg.mamba2_headdim, cfg.ssm_state
    bsz, _, nh = dt.shape
    di = nh * hd
    a_neg = -torch.exp(params["A_log"])
    a_c = a_neg.repeat_interleave(hd)[:, None].expand(di, ds).contiguous()
    h3 = h.view(bsz, di, ds)
    dt_c = dt.repeat_interleave(hd, dim=-1)
    if train:
        y, h_t = SelectiveScanFn.apply(dt_c, b_mat, c_mat, x32, a_c, h3)
        h_t = h_t.view(h.shape)
    else:
        y, _ = selective_scan(dt_c, b_mat, c_mat, x32, a_c, h3, h_out=h3)
        h_t = h
    return y, params["D"].repeat_interleave(hd), h_t


def mamba2_seq(params, x, cfg, h0=None, conv_state=None, train=False):
    """A chunk. x: (B,T,D) -> (out, (h_T, conv_state_T)).

    ``h0`` (B,nh,headdim,ds) f32 and ``conv_state`` (B,W-1,di) resume
    the recurrence and are updated in place, as in :func:`mamba1_seq`;
    None means start-of-sequence zeros (fresh tensors are returned).
    ``train``: from zero state, through :class:`SelectiveScanFn`."""
    b = x.shape[0]
    di, ds, hd = cfg.d_inner_eff, cfg.ssm_state, cfg.mamba2_headdim
    xz = x @ params["in_proj"]
    x_i, z = torch.split(xz, di, dim=-1)
    x_c = F.silu(_causal_conv(x_i, params["conv_w"], params["conv_b"],
                              conv_state))
    dt, b_mat, c_mat = _mamba2_inner(params, x, cfg)
    x32 = x_c.to(torch.float32)
    if h0 is None:
        h0 = torch.zeros((b, di // hd, hd, ds), dtype=torch.float32,
                         device=x.device)
    y, d_skip, h_t = _mamba2_scan(params, dt, b_mat, c_mat, x32, h0, cfg,
                                  train)
    out = _gate_out(params, y, x32, z, x.dtype, d_skip)
    return out, (h_t, _next_conv_state(x_i, conv_state, cfg))


def mamba2_step(params, x, state, cfg):
    """A decode step. x: (B,1,D); state = (h (B,nh,headdim,ds) f32, conv
    (B,W-1,di)), both updated in place.  Returns (out (B,1,D), state)."""
    h, conv_state = state
    di = cfg.d_inner_eff
    xz = (x @ params["in_proj"])[:, 0]
    x_i, z = torch.split(xz, di, dim=-1)                   # (B, di)
    x_c, nxt = _conv_step(conv_state, x_i, params["conv_w"],
                          params["conv_b"])
    conv_state.copy_(nxt)
    x_c = F.silu(x_c)[:, None, :]                          # (B, 1, di)
    dt, b_mat, c_mat = _mamba2_inner(params, x, cfg)
    x32 = x_c.to(torch.float32)
    y, d_skip, _ = _mamba2_scan(params, dt, b_mat, c_mat, x32, h, cfg)
    out = _gate_out(params, y, x32, z[:, None, :], x.dtype, d_skip)
    return out, (h, conv_state)
