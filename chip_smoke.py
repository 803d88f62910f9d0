#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (at first
use, into ``build/repro_torch/``) and runs these phases, each printing
one JSON line:

1. ``device``  — the card's name and power limit (nvidia-smi);
2. ``build``   — compile and load the kernel library, with its seconds;
   then a second ``device`` line: the card's SM count and how many
   clusters of 1-8 CTAs it holds at once at the wide bodies' shared
   memory (the paged prefill's, the ring form's and the decode's),
   against the constants the split rules read (``SM_COUNT`` of four
   kernel modules, ``WIDE_CLUSTERS``): a mismatch fails by name before
   any kernel phase;
3. ``kernels`` — every kernel against its plain PyTorch version on the
   card at the main path's shapes, in float32 (tolerance 2e-5; 1e-4 for
   the quant matmuls, whose sums over K up to 2560 run in another order;
   2e-5 of max(1, |plain|) for the selective scan, whose outputs reach
   tens, in float32 only, the dtype the model feeds it) and bfloat16
   (2e-2, and every element within two bf16 rounding steps of its own
   value: both sides compute in f32 and round once), with the kernel's,
   the plain version's and one PyTorch library call's device time
   (torch.profiler; no single PyTorch call computes the scan's
   recurrence, so it has none), the kernel's time per back-to-back call
   (CUDA events, launch cost included), and the least time the card
   could take.  For the five kernels with a tensor-core body (paged
   prefill, int8 and int4 quant matmul, paged and dense decode) the
   bf16 cases also time the previous CUDA-core body on the same inputs,
   in turns with the new one (new, old, old, new), as ``prev_ms``, and
   gate its output too; so do the selective scan's cases for its
   previous body (``cuda_core``, against ``state_lanes``), whose
   ``h_T`` must also equal the new body's bit for bit, and which print
   the scan's instruction-issue bound beside the bytes bound.  rmsnorm
   runs on its ``norm`` body (against ``F.rms_norm``; bf16 also against
   its previous ``cuda_core`` body) and fused with the residual add on
   its ``add_norm`` body, whose ``r`` must equal torch's ``x + delta``
   bit for bit and whose ``out`` is gated like any output; the fused
   case's previous composition (torch's add, then the ``cuda_core``
   norm) is its ``prev_ms``, and torch's add then ``F.rms_norm`` its
   ``library_pair_ms`` (no single PyTorch call computes it, so its
   ``library_ms`` is null).  rmsnorm is also checked and timed at the
   train step's 32768 rows of 960 and at the widths of falcon-mamba-7b
   and gemma3-12b (8 and 128 rows of 4096 and of 3840, bf16).  The batched paged-chunk form
   of the flash kernel (``paged_chunk_attention``, a verify round's B 8
   rows of C = K + 1 = 5 tokens, each row's pos read on the device) must
   also give each row the bits of a one-row call at its pos, and the
   same bits in blocks of 32 as in blocks of 16; its library call is
   ``F.scaled_dot_product_attention`` over the gathered KV with a per-row
   mask.  The window form of the flash kernel
   (``ring_chunk_attention``: C 128 queries of gemma3-12b's 16 heads of
   256 over a ring of w = 1024 slots plus the chunk's own keys) runs at
   pos 0, 512 and 3000 in float32 (``cuda_core``) and bfloat16 (``mma``,
   timed in turns against ``cuda_core``), must give the same bits in
   blocks of 32 and as a dense one-block ring as in blocks of 16, and
   with pos read on the device as with a host int, and prints both
   halves of its bound; its library call is
   ``F.scaled_dot_product_attention`` over ``[gathered ring ; chunk]``
   with the boolean window mask.  The attention kernels also run at
   gemma3's hd 256: the one-row prefill (C 128 at pos 1024 and 2048)
   and both decode kernels (B 8, pos 5-2000, over linear rows and over
   rings) in bfloat16 on their wide ``mma`` bodies, timed in turns
   against ``cuda_core``, the prefill's bits the same in blocks of 16,
   32 and one dense block and the dense decode's the paged decode's on
   the same rows; and in float32 on ``cuda_core`` (prefill at pos 1024,
   decode over linear rows).  The contiguous form of the flash kernel
   (``flash_attention``, the TPU kernel's own signature, the train
   path's) runs at smollm-360m's train shape (B 8, S 4096, 15 / 5 heads
   of 64, causal, bf16 on ``mma``), the same heads at S 1024 in float32
   (``cuda_core``), gemma3-12b's heads with its 1024 window (bf16, the
   wide tiles) and a non-causal ragged case (B 2, S 1000, with a window
   it must ignore) in both dtypes, its row log-sum-exp within 2e-5 /
   1e-2, beside ``F.scaled_dot_product_attention`` (``enable_gqa``;
   causal, or the boolean window mask), and the torch-op gradient of one
   layer timed at the train shape; ``FlashAttentionFn``'s dq / dk / dv
   (B 2, S 512) and the norms' gradients and their Functions' forward
   (8 and 128 rows of 960, and in bf16 the train step's 32768) are held
   to autograd through the plain versions.  An empty kernel
   (``csrc/launch_floor.cu``; not a port of any TPU kernel, so not in
   the kernel list) gives the floor one launch costs, at 1 block and at
   the decode scan's grid;
4. ``parity``  — smollm-360m at full width, 2 layers, float32: one trace
   through the paged engine (unquantized, int8, int4) and the slot
   engine ``ServingEngine`` (unquantized, int8) on the card (kernels)
   and on the CPU (plain versions), and with ``speculative=4``: n-gram
   drafts through the paged engine (unquantized and int8) and the slot
   engine, and a model draft (2-layer smollm-360m on its own seed)
   through the paged engine; then falcon-mamba-7b and gemma3-12b (one
   ``swa`` layer with the published window of 1024, one ``attn``; 3
   prompts of 1040-1200 tokens, so every ring wraps) at full width, 2
   layers, float32, through the paged and the slot engine, and with
   ``speculative=4``, which both must gate off.  Each pair of streams must
   be equal, on the card the slot engine's streams must equal the paged
   engine's, and each speculative stream the same engine's and format's
   non-speculative one;
5. ``serve``   — smollm-360m at full width and depth in bfloat16 with
   random weights from a seed: 16 requests through
   ``PagedServingEngine``, then 8 of them through ``ServingEngine`` and
   through ``PagedServingEngine`` with int8 and with int4 weights; every
   request must finish with 64 in-vocab tokens and every kernel must
   have been launched the number of times each run's shapes imply (the
   counts are reset before and read after each run), every launch
   of the six two-body kernels must have taken its tensor-core body
   (all serve runs are bf16), and rmsnorm's launches must split between
   its ``add_norm`` and ``norm`` bodies as the run implies; each
   quantized or
   slot run prints the share of its tokens equal to the bf16 paged
   run's on the same requests (not gated: random 32-layer weights);
   the last run repeats the bf16 paged engine on the same 8 requests.
   Then ``speculative=4`` (n-gram drafts) through the paged and the slot
   engine on those 8 requests (``paged_spec``, ``dense_spec``): rounds,
   acceptance, host syncs per token, the share of tokens equal to the
   repeated bf16 paged run's (not gated), and exactly one batched chunk
   attention a layer a round, every launch on ``mma``.
   Then falcon-mamba-7b at full width and depth (64 Mamba1 layers) in
   bfloat16: 8 requests through ``PagedServingEngine`` and the same 8
   through ``ServingEngine``, with the same checks (the slot run's share
   of tokens equal to the paged run's printed, and every scan launch on
   the ``state_lanes`` body).
   Then gemma3-12b at full width and depth (48 layers, 40 ``swa`` with
   the 1024-slot ring, 8 ``attn``) in bfloat16, about 23.5 GB of weights
   drawn on the card: 8 requests of 256-2048 tokens (six past the
   window), 64 new tokens each, through ``PagedServingEngine``
   (``gemma_paged_bf16``, profiled in decode and prefill, with prompts
   past the window) and ``ServingEngine`` (``gemma_dense_bf16``, its
   share of tokens equal to the paged run's printed); a prefill chunk
   launches the ring form 40 times and the paged prefill 8 times, a
   decode iteration the decode kernel 48 times, checked exactly: the
   paged prefill, the ring form and the decode on the wide ``mma``
   bodies (hd 256).  Which body each attention kernel's launches take is
   fixed per config in ``ATTN_BODY`` (``mma`` for all five two-body
   attention kernels of smollm-360m and gemma3-12b), and the wrappers'
   rules must agree with it.
   ``profile`` (after the bf16, int8 and int4 smollm paged runs and the
   falcon-mamba and gemma3 paged runs; two steady verify rounds after
   ``paged_spec``):
   two steady decode macro-steps timed without
   the profiler, then the same window again under torch.profiler for
   the device's busy time, the top kernels and the port's own kernels
   by device time; the idle share is one minus busy over the
   unprofiled wall time.  After the bf16 smollm paged run and the
   falcon-mamba paged run, the same for a prefill window: 8 requests of
   385 tokens admitted at once, 24 chunks of 128, with the device busy
   time per chunk (gemma3: 8 requests of 1153 tokens, 72 chunks).  The
   bf16 smollm and gemma3 decode and prefill windows, the int8 and
   int4 decode windows and both falcon-mamba windows run again with the
   previous (CUDA-core) body of the paged decode, the paged prefill
   (gemma3: and the ring form), the int8 or int4 quant matmul, or the
   selective scan, and the bf16
   smollm and falcon-mamba decode and prefill windows with the previous
   rmsnorm (torch's residual add, then the ``cuda_core`` norm), for the
   busy time and the launches each redesign saves.

6. ``train``  — smollm-360m at full width, 2 layers, float32, on the
   card against the CPU from the same weights: the loss (1e-5 relative)
   and every gradient leaf (1e-5 of max(1, |g|)) of one step, AdamW fed
   the same gradients on both sides (1e-6), and the loss at each of three
   ``make_train_step`` steps (1e-5 relative); then smollm-360m at full
   width and depth in bf16 with f32 AdamW state, 8 steps at B 8, S 4096
   through ``launch/train.py``'s setup, a line a step (ce, grad norm,
   lr, wall ms, tokens/s, peak memory): every ce finite and the last
   below the first, the launches exactly what ``expected_train_launches``
   implies (the flash kernel twice a layer a step, all on ``mma``:
   forward and the checkpoint's recompute; 4n + 1 norms), no plain
   version run; then one more step under torch.profiler (busy ms, idle
   share, the flash kernel's, the torch-op backward's and cuBLAS's ms).

Each phase ends with a line of its wall seconds, as each serve run's and
each profile's line carries its own.  It then prints the kernel list,
the card's name and power limit, and as its last line ``{"ok": true,
"device": {...}}``.  Any failure raises
and the exit code is non-zero.  Without a CUDA device it exits with
code 2 before printing anything.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-5   # two bf16 rounding steps
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM, 80 GB HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, no sparsity
QMM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # sums over K <= 2560
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:20",
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:158",
    "paged_prefill_attention": "src/repro/kernels/flash_attention.py:72",
    "paged_chunk_attention": "src/repro/kernels/flash_attention.py:72",
    "ring_chunk_attention": "src/repro/kernels/flash_attention.py:72",
    "dense_decode_attention": "src/repro/kernels/decode_attention.py:76",
    "quant_matmul_int8": "src/repro/kernels/quant_matmul.py:54",
    "quant_matmul_int4": "src/repro/kernels/quant_matmul.py:54",
    "selective_scan": "src/repro/kernels/selective_scan.py:61",
    "flash_attention": "src/repro/kernels/flash_attention.py:72",
}
SOURCES = {
    "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
    "paged_decode_attention": "src/repro_torch/csrc/paged_decode_attention.cu",
    "paged_prefill_attention": "src/repro_torch/csrc/paged_prefill_attention.cu",
    "paged_chunk_attention": "src/repro_torch/csrc/paged_prefill_attention.cu",
    "ring_chunk_attention": "src/repro_torch/csrc/ring_chunk_attention.cu",
    "dense_decode_attention": "src/repro_torch/csrc/dense_decode_attention.cu",
    "quant_matmul_int8": "src/repro_torch/csrc/quant_matmul.cu",
    "quant_matmul_int4": "src/repro_torch/csrc/quant_matmul.cu",
    "selective_scan": "src/repro_torch/csrc/selective_scan.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
}
#: the serve run whose launches each kernel's line reports
LAUNCH_RUN = {"rmsnorm": "paged_bf16", "paged_decode_attention": "paged_bf16",
              "paged_prefill_attention": "paged_bf16",
              "paged_chunk_attention": "paged_spec",
              "ring_chunk_attention": "gemma_paged_bf16",
              "dense_decode_attention": "dense_bf16",
              "quant_matmul_int8": "paged_int8",
              "quant_matmul_int4": "paged_int4",
              "selective_scan": "mamba_paged_bf16",
              "flash_attention": "train_bf16"}
#: the dtype of each kernel's main-path case in the kernels line
MAIN_DTYPE = {"selective_scan": "float32"}
#: the bodies every serve-run launch of a kernel with more than one body
#: must take (rmsnorm: split as expected_launches says; the attention
#: kernels as ``ATTN_BODY`` names them for the run's config)
MAIN_BODY = {"selective_scan": ("state_lanes",),
             "rmsnorm": ("add_norm", "norm")}   # the others: ("mma",)
#: the rule that names each two-body attention kernel's body
ATTN_RULE = {"paged_prefill_attention": "prefill_body",
             "paged_chunk_attention": "prefill_body",
             "ring_chunk_attention": "ring_body",
             "paged_decode_attention": "decode_body",
             "dense_decode_attention": "decode_body"}
#: the body of every launch of each attention kernel, per served config,
#: fixed here (a config not named takes mma everywhere): gemma3-12b's hd
#: 256 takes the wide mma bodies of the paged prefill, the batched chunk,
#: the ring form and both decodes.  ``main_bodies`` checks that the
#: wrappers' rules agree.
ATTN_BODY = {"gemma3-12b": {"paged_prefill_attention": "mma",
                            "paged_chunk_attention": "mma",
                            "ring_chunk_attention": "mma",
                            "paged_decode_attention": "mma",
                            "dense_decode_attention": "mma"}}
#: the scan's issue bound: the thread instructions one state update
#: takes as the card compiles it (cuobjdump of csrc/selective_scan.cu:
#: dt*a, the accurate expf's eight, decay*h, dx*B, their sum, h*C and
#: its add to y), with no loads, over the card's issue rate (132 SMs x 4
#: schedulers x one 32-thread instruction a clock at the H100 SXM's
#: 1.98 GHz boost clock)
SCAN_INSTR_PER_UPDATE = 14
ISSUE_PER_S = 132 * 4 * 32 * 1.98e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def call_ms(fn, n: int = 50, warmup: int = 5) -> float:
    """Mean time per call of ``fn`` over ``n`` back-to-back calls (CUDA
    events): the device time, or the host's launch time when that is
    longer, as it is for kernels of a few microseconds."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int = 20, warmup: int = 3, attempts: int = 3) -> float:
    """Device time per call of ``fn``: the summed durations of the
    kernels it launches, from torch.profiler, over ``n`` calls (inputs
    warm in L2).  Host launch gaps are not counted.  A profile that
    recorded no device activity at all (torch.profiler drops a window
    now and then) is taken again, up to ``attempts`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / n
    raise RuntimeError(f"torch.profiler recorded no device time in "
                       f"{attempts} profiles")


def bound(nbytes: float, flops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def _errors(out, ref, dtype, tol, relative) -> tuple:
    """(max abs error, max error relative to max(1, |ref|), bf16 step
    excess, within the gate)."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    rel = (diff / ref.float().abs().clamp(min=1.0)).max().item()
    gated = rel if relative else err
    # bf16: how far the worst element lies beyond two rounding steps
    excess = ((diff - BF16_RTOL * ref.float().abs()).max().item()
              if dtype == "bfloat16" else None)
    ok = (bool(np.isfinite(gated)) and gated <= tol[dtype]
          and (excess is None or excess <= BF16_ATOL))
    return err, rel, excess, ok


def _case(name, dtype, shape, out, ref, fn, plain, library, nbytes, flops,
          tol=TOL, relative=False, library_note=None, prev=None,
          prev_out=None, extra=None):
    """One kernel case: ``out`` (kernel) against ``ref`` (plain) on the
    card, then the timings.  ``relative`` gates the error relative to
    max(1, |ref|) instead of the absolute one.  ``prev``: the kernel's
    previous (CUDA-core) body on the same inputs, gated the same way
    (on ``prev_out`` where given, else on what ``prev()`` returns) and
    timed in turns with the kernel (kernel, prev, prev, kernel).
    ``extra``: more keys for the case's line."""
    import torch
    torch.cuda.synchronize()
    err, rel, excess, ok = _errors(out, ref, dtype, tol, relative)
    b_ms, b_by = bound(nbytes, flops, dtype)
    prev_case = {}
    if prev is None:
        ms = device_ms(fn)
    else:
        p_err, _, p_excess, p_ok = _errors(
            prev() if prev_out is None else prev_out, ref, dtype, tol,
            relative)
        turns = [device_ms(f) for f in (fn, prev, prev, fn)]
        ms = (turns[0] + turns[3]) / 2
        prev_case = {"prev_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
                     "prev_max_abs_err": p_err,
                     "prev_bf16_step_excess": p_excess}
        ok = ok and p_ok
    case = {"kernel": name, "dtype": dtype, "shape": shape,
            "max_abs_err": err, "max_rel_err": rel,
            "tol": tol[dtype], "tol_on": "relative" if relative else "abs",
            "bf16_step_excess": excess, "ok": ok,
            "ms": ms, "prev_ms": None, **prev_case,
            "plain_ms": device_ms(plain),
            "library_ms": device_ms(library) if library else None,
            "call_ms": call_ms(fn),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops, **(extra or {})}
    if library_note:
        case["library_note"] = library_note
    emit({"phase": "kernels", **case})
    if not ok:
        raise AssertionError(f"{name} {dtype} {shape}: kernel disagrees "
                             f"with its plain version (max abs err {err}, "
                             f"max err relative to max(1, |plain|) {rel}, "
                             f"limit {tol[dtype]} on the "
                             f"{case['tol_on']} one; bf16 step excess "
                             f"{excess}, limit {BF16_ATOL}; previous body "
                             f"{prev_case})")
    return case


def kernel_cases(dev) -> list:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        dense_decode_attention, dense_decode_attention_plain,
        paged_decode_attention, paged_decode_attention_plain, paged_gather)
    from repro_torch.kernels.quant_matmul import (
        quant_matmul_int4, quant_matmul_int4_plain, quant_matmul_int8,
        quant_matmul_int8_plain)
    from repro_torch.models.quantize import (dequantize, quantize_int4,
                                             quantize_int8)
    from repro_torch.kernels.flash_attention import (
        paged_prefill_attention, paged_prefill_attention_plain)
    from repro_torch.kernels.rmsnorm import (add_rmsnorm, add_rmsnorm_plain,
                                             rmsnorm, rmsnorm_plain)

    rng = np.random.default_rng(SEED)
    cases = []
    H, KV, HD, BS, MAX_LEN, D = 15, 5, 64, 16, 1024, 960
    nb = MAX_LEN // BS

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        es = torch.finfo(dtype).bits // 8

        # rmsnorm: 8 decode rows, 128 prefill rows of d_model, and in
        # bf16 smollm-360m's train step (B 8 x S 4096 = 32768 rows, every
        # norm of the step and of its recompute) and the served models'
        # own widths: falcon-mamba-7b's 4096 (65 norms an iteration) and
        # gemma3-12b's 3840 (97 norms an iteration, 96 a chunk; 480
        # 16-byte accesses a row, so 8 warps with a partial second access
        # a lane, a launch shape no other width takes)
        widths = [(D, 8), (D, 128)] + ([(D, TRAIN_ROWS), (4096, 8),
                                        (4096, 128), (3840, 8), (3840, 128)]
                                       if dname == "bfloat16" else [])
        for d, rows in widths:
            x = t(rng.standard_normal((rows, d)), dtype)
            sc = t(1 + 0.1 * rng.standard_normal(d), dtype)
            cases.append(_case(
                "rmsnorm", dname, [rows, d], rmsnorm(x, sc, 1e-5),
                rmsnorm_plain(x, sc, 1e-5), lambda: rmsnorm(x, sc, 1e-5),
                lambda: rmsnorm_plain(x, sc, 1e-5),
                lambda: F.rms_norm(x, (d,), sc, 1e-5),
                2 * rows * d * es + d * es, 4 * rows * d,
                prev=(lambda: rmsnorm(x, sc, 1e-5, _body="cuda_core"))
                if dname == "bfloat16" else None,
                extra={"body": "norm"}))
        # fused with the residual add before it: the add_norm body of 64
        # of those 65 norms
        for d, rows in widths:
            x = t(rng.standard_normal((rows, d)), dtype)
            dl = t(rng.standard_normal((rows, d)), dtype)
            sc = t(1 + 0.1 * rng.standard_normal(d), dtype)
            r, out = add_rmsnorm(x, dl, sc, 1e-5)
            r_equal = torch.equal(r, x + dl)
            emit({"phase": "kernels", "kernel": "rmsnorm",
                  "check": "add_norm's r bit-equal to torch's x + delta",
                  "dtype": dname, "shape": [rows, d], "equal": r_equal})
            if not r_equal:
                raise AssertionError(f"add_rmsnorm {dname} {[rows, d]}: r "
                                     f"differs from torch's x + delta")
            cases.append(_case(
                "rmsnorm", dname, [rows, d], out,
                add_rmsnorm_plain(x, dl, sc, 1e-5)[1],
                lambda: add_rmsnorm(x, dl, sc, 1e-5),
                lambda: add_rmsnorm_plain(x, dl, sc, 1e-5), None,
                # x, delta read, r, out written; scale once; per element
                # the add, the square, its sum and two products
                (4 * rows * d + d) * es, 5 * rows * d,
                library_note="none: no single PyTorch call computes the "
                             "add and the norm; library_pair_ms is the "
                             "two-call pair torch.add, F.rms_norm",
                prev=lambda: add_rmsnorm(x, dl, sc, 1e-5,
                                         _body="cuda_core")[1],
                extra={"body": "add_norm", "library_pair_ms": device_ms(
                    lambda: F.rms_norm(x + dl, (d,), sc, 1e-5))}))

        # paged decode: B = 8 rows, positions up to ~600, one masked row
        # (frozen pos, all-zero table -> the scratch block 0)
        B = 8
        nbp = B * nb + 1
        kp = t(rng.standard_normal((nbp, BS, KV, HD)), dtype)
        vp = t(rng.standard_normal((nbp, BS, KV, HD)), dtype)
        tables_np = (rng.permutation(nbp - 1)[:B * nb].reshape(B, nb) + 1)
        pos_np = rng.integers(64, 640, size=B)
        tables_np[B - 1] = 0
        pos_np[B - 1] = 5
        tables = torch.from_numpy(tables_np.astype(np.int32)).to(dev)
        pos = torch.from_numpy(pos_np.astype(np.int32)).to(dev)
        q = t(rng.standard_normal((B, H, HD)), dtype)
        kg = paged_gather(kp, tables).permute(0, 2, 1, 3).contiguous()
        vg = paged_gather(vp, tables).permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(MAX_LEN, device=dev)[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        n_keys = int(np.minimum(pos_np, MAX_LEN - 1).sum() + B)
        cases.append(_case(
            "paged_decode_attention", dname,
            {"B": B, "H": H, "KV": KV, "hd": HD, "bs": BS,
             "pos": pos_np.tolist()},
            paged_decode_attention(q, kp, vp, tables, pos),
            paged_decode_attention_plain(q, kp, vp, tables, pos),
            lambda: paged_decode_attention(q, kp, vp, tables, pos),
            lambda: paged_decode_attention_plain(q, kp, vp, tables, pos),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True),
            2 * B * H * HD * es + 2 * n_keys * KV * HD * es
            + 4 * (n_keys // BS + B) + 4 * B,
            4 * H * HD * n_keys,
            prev=(lambda: paged_decode_attention(q, kp, vp, tables, pos,
                                                 _body="cuda_core"))
            if dname == "bfloat16" else None))

        # paged prefill: a chunk of C = 128 at pos 0 (identity table over
        # contiguous K/V) and at pos 256 (shuffled table)
        C = 128
        for p0 in (0, 256):
            nbp = nb + 1
            kp = t(rng.standard_normal((nbp, BS, KV, HD)), dtype)
            vp = t(rng.standard_normal((nbp, BS, KV, HD)), dtype)
            if p0 == 0:
                table_np = np.arange(nb)
            else:
                table_np = rng.permutation(nbp - 1)[:nb] + 1
            table = torch.from_numpy(table_np.astype(np.int32)).to(dev)
            q = t(rng.standard_normal((C, H, HD)), dtype)
            n_slots = p0 + C
            kc = paged_gather(kp, table[None])[0, :n_slots].permute(1, 0, 2)
            vc = paged_gather(vp, table[None])[0, :n_slots].permute(1, 0, 2)
            kc, vc = kc[None].contiguous(), vc[None].contiguous()
            qs = q.permute(1, 0, 2)[None].contiguous()
            cmask = (torch.arange(n_slots, device=dev)[None, :]
                     <= p0 + torch.arange(C, device=dev)[:, None])
            out = paged_prefill_attention(q, kp, vp, table, p0)
            if p0 == 0:
                # what flash_attention_pallas(causal=True) computes for
                # contiguous K/V, written out in f32
                g = H // KV
                s = torch.einsum("nghd,nkd->nghk",
                                 qs[0].float().reshape(KV, g, C, HD),
                                 kc[0].float()) * HD ** -0.5
                s = s.masked_fill(~cmask, -1e30)
                ref = torch.einsum("nghk,nkd->nghd", torch.softmax(s, -1),
                                   vc[0].float()).reshape(H, C, HD)
                flash_err = (out.float().permute(1, 0, 2) - ref).abs().max().item()
                emit({"phase": "kernels", "kernel": "paged_prefill_attention",
                      "check": "identity table vs contiguous causal attention",
                      "dtype": dname, "max_abs_err": flash_err,
                      "tol": TOL[dname]})
                if not flash_err <= TOL[dname]:
                    raise AssertionError(
                        f"prefill at pos 0 disagrees with contiguous causal "
                        f"attention ({flash_err})")
            n_pairs = sum(p0 + i + 1 for i in range(C))
            cases.append(_case(
                "paged_prefill_attention", dname,
                {"C": C, "H": H, "KV": KV, "hd": HD, "bs": BS, "pos": p0},
                out, paged_prefill_attention_plain(q, kp, vp, table, p0),
                lambda: paged_prefill_attention(q, kp, vp, table, p0),
                lambda: paged_prefill_attention_plain(q, kp, vp, table, p0),
                (lambda: F.scaled_dot_product_attention(
                    qs, kc, vc, is_causal=True, enable_gqa=True))
                if p0 == 0 else
                (lambda: F.scaled_dot_product_attention(
                    qs, kc, vc, attn_mask=cmask, enable_gqa=True)),
                2 * C * H * HD * es + 2 * n_slots * KV * HD * es
                + 4 * (-(-n_slots // BS)),
                4 * H * HD * n_pairs,
                prev=(lambda: paged_prefill_attention(
                    q, kp, vp, table, p0, _body="cuda_core"))
                if dname == "bfloat16" else None))

        cases.append(chunk_case(dev, dname))

    # the kernels of the quantized and slot-engine paths
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        es = torch.finfo(dtype).bits // 8

        # quant matmul at a decode site (8 rows, w_gate / w_up) and a
        # prefill one (a chunk of 128 rows, w_down); the library call is
        # the dense matmul the unquantized model runs there
        for m, k, n in ((8, 960, 2560), (128, 2560, 960)):
            w = t(rng.standard_normal((k, n)) * k ** -0.5, torch.float32)
            x = t(rng.standard_normal((m, k)), dtype)
            for fmt in ("int8", "int4"):
                packed = (quantize_int8 if fmt == "int8"
                          else quantize_int4)(w)
                q, s = packed["q"], packed["s"]
                w_dense = dequantize(packed).to(dtype)
                kernel, plain = ((quant_matmul_int8, quant_matmul_int8_plain)
                                 if fmt == "int8" else
                                 (quant_matmul_int4, quant_matmul_int4_plain))
                cases.append(_case(
                    f"quant_matmul_{fmt}", dname, [m, k, n],
                    kernel(x, q, s), plain(x, q, s),
                    lambda: kernel(x, q, s), lambda: plain(x, q, s),
                    lambda: torch.matmul(x, w_dense),
                    m * k * es + q.numel() + 4 * s.numel() + m * n * es,
                    2 * m * k * n, tol=QMM_TOL,
                    prev=(lambda: kernel(x, q, s, _body="cuda_core"))
                    if dname == "bfloat16" else None))

        # dense decode: the slot engine's 8 rows of S = 1024 slots,
        # positions up to ~600, one row frozen at pos 5 (budget run out)
        B, S = 8, 1024
        kc = t(rng.standard_normal((B, S, KV, HD)), dtype)
        vc = t(rng.standard_normal((B, S, KV, HD)), dtype)
        pos_np = rng.integers(64, 640, size=B)
        pos_np[B - 1] = 5
        pos = torch.from_numpy(pos_np.astype(np.int32)).to(dev)
        q = t(rng.standard_normal((B, H, HD)), dtype)
        kt = kc.permute(0, 2, 1, 3).contiguous()
        vt = vc.permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(S, device=dev)[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        n_keys = int(np.minimum(pos_np, S - 1).sum() + B)
        cases.append(_case(
            "dense_decode_attention", dname,
            {"B": B, "H": H, "KV": KV, "hd": HD, "S": S,
             "pos": pos_np.tolist()},
            dense_decode_attention(q, kc, vc, pos),
            dense_decode_attention_plain(q, kc, vc, pos),
            lambda: dense_decode_attention(q, kc, vc, pos),
            lambda: dense_decode_attention_plain(q, kc, vc, pos),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True),
            2 * B * H * HD * es + 2 * n_keys * KV * HD * es + 4 * B,
            4 * H * HD * n_keys,
            prev=(lambda: dense_decode_attention(q, kc, vc, pos,
                                                 _body="cuda_core"))
            if dname == "bfloat16" else None))
    launch_floor(dev)
    return cases + scan_cases(dev) + gemma_cases(dev) + flash_cases(dev)


# ---------------------------------------------------------------------------
# phase 3 (continued): the contiguous flash form and the gradients
# ---------------------------------------------------------------------------
#: the contiguous flash form's cases: (label, dtype, B, S, H, KV, hd,
#: causal, window).  "train": smollm-360m's train shape (the reference's
#: train_4k sequence on one card's 8 rows), on mma; "train_f32": the same
#: heads at S 1024 in float32, on cuda_core; "gemma": gemma3-12b's heads
#: with its window (the wide tiles); "encoder": non-causal and ragged,
#: with a window the kernel must ignore
FLASH_CASES = [("train", "bfloat16", 8, 4096, 15, 5, 64, True, 0),
               ("train_f32", "float32", 8, 1024, 15, 5, 64, True, 0),
               ("gemma", "bfloat16", 1, 4096, 16, 8, 256, True, 1024),
               ("encoder", "float32", 2, 1000, 6, 2, 64, False, 100),
               ("encoder", "bfloat16", 2, 1000, 6, 2, 64, False, 100)]
FLASH_LSE_TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def flash_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head of one row computes: S^2 when not
    causal, S(S + 1)/2 causal, and with a window w < S, w(w + 1)/2 +
    (S - w) w."""
    if not causal:
        return s * s
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _grad_err(got, want) -> float:
    """Largest gradient difference relative to max(1, |want|)."""
    return max(((g.float() - w.float()).abs()
                / w.float().abs().clamp(min=1.0)).max().item()
               for g, w in zip(got, want))


def flash_cases(dev) -> list:
    """The contiguous flash form (``flash_attention``, the TPU kernel's
    own signature) at ``FLASH_CASES``: out against the plain version
    under the gates, the row log-sum-exp within ``FLASH_LSE_TOL``, each
    launch on the body ``prefill_body`` names, timed beside its plain
    version and ``F.scaled_dot_product_attention`` (``enable_gqa``;
    ``is_causal``, or the boolean window mask where there is a window);
    at the train shape also the torch-op gradient
    (``flash_attention_backward``, one layer's).  Then
    ``FlashAttentionFn``'s dq / dk / dv and the norms' gradients
    (``rmsnorm``, ``add_rmsnorm`` through their autograd Functions, on
    the kernels) against autograd through the plain versions on the
    card, within TOL of max(1, |g|)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        FlashAttentionFn, flash_attention, flash_attention_backward,
        flash_attention_plain, prefill_body)
    from repro_torch.kernels.rmsnorm import (add_rmsnorm, add_rmsnorm_plain,
                                             rmsnorm, rmsnorm_plain)
    rng = np.random.default_rng(SEED + 11)
    cases = []

    def t(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, dtype)

    for label, dname, B, S, H, KV, HD, causal, window in FLASH_CASES:
        dtype = getattr(torch, dname)
        es = torch.finfo(dtype).bits // 8
        q, k, v = t((B, H, S, HD), dtype), t((B, KV, S, HD), dtype), t(
            (B, KV, S, HD), dtype)
        kw = dict(causal=causal, window=window)
        body = prefill_body(dtype, HD)
        out, lse = _on_body("flash_attention", body,
                            lambda: flash_attention(q, k, v, **kw))
        ref, ref_lse = flash_attention_plain(q, k, v, **kw)
        lse_err = (lse - ref_lse).abs().max().item()
        if causal and window:
            pos = torch.arange(S, device=dev)
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
            lib_kw = dict(attn_mask=mask)
        else:
            lib_kw = dict(is_causal=causal)
        pairs = flash_pairs(S, causal, window if causal else 0)
        nbytes = (2 * B * H + 2 * B * KV) * S * HD * es + 4 * B * H * S
        flops = 4 * HD * B * H * pairs
        extra = {"body": body, "lse_max_abs_err": lse_err,
                 "lse_tol": FLASH_LSE_TOL[dname],
                 **_bounds(nbytes, flops, dname)}
        if label == "train":
            dout = t((B, H, S, HD), dtype)
            extra["backward_ms"] = device_ms(
                lambda: flash_attention_backward(q, k, v, out, lse, dout,
                                                 **kw), n=5, warmup=1)
            extra["backward_note"] = ("flash_attention_backward, torch "
                                      "ops, one layer's gradient")
            del dout
        cases.append(_case(
            "flash_attention", dname,
            {"label": label, "B": B, "S": S, "H": H, "KV": KV, "hd": HD,
             "causal": causal, "window": window}, out, ref,
            lambda: flash_attention(q, k, v, **kw),
            lambda: flash_attention_plain(q, k, v, **kw),
            lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                   **lib_kw),
            nbytes, flops, extra=extra))
        if not lse_err <= FLASH_LSE_TOL[dname]:
            raise AssertionError(f"flash_attention {label} {dname}: row "
                                 f"log-sum-exp off by {lse_err}")
        del q, k, v, out, lse, ref, ref_lse, lib_kw
        torch.cuda.empty_cache()

    # gradients: FlashAttentionFn (the kernel's forward, the torch-op
    # backward) against autograd through the plain version
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for causal, window in ((True, 0), (True, 128), (False, 0)):
            x = [t(shape, dtype) for shape in ((2, 15, 512, 64),
                                               (2, 5, 512, 64),
                                               (2, 5, 512, 64))]
            w = t((2, 15, 512, 64), torch.float32)
            a = [y.clone().requires_grad_(True) for y in x]
            got = torch.autograd.grad((FlashAttentionFn.apply(
                *a, causal, window, None).float() * w).sum(), a)
            p = [y.clone().requires_grad_(True) for y in x]
            want = torch.autograd.grad((flash_attention_plain(
                *p, causal=causal, window=window)[0].float() * w).sum(), p)
            err = _grad_err(got, want)
            emit({"phase": "kernels", "kernel": "flash_attention",
                  "check": "FlashAttentionFn dq, dk, dv vs autograd through "
                           "the plain version", "dtype": dname,
                  "shape": {"B": 2, "S": 512, "H": 15, "KV": 5, "hd": 64,
                            "causal": causal, "window": window},
                  "max_rel_err": err, "tol": TOL[dname]})
            if not err <= TOL[dname]:
                raise AssertionError(f"flash_attention gradients {dname}: "
                                     f"{err} of max(1, |g|)")

    # the norms' gradients: rmsnorm and add_rmsnorm through their
    # autograd Functions (the norm / add_norm kernels forward, torch ops
    # backward) against autograd through the plain versions, in bf16
    # also at the train step's rows; the Functions' forward outputs (the
    # train path's own calls) held to the kernels' gate
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for rows in (8, 128) + ((TRAIN_ROWS,) if dname == "bfloat16"
                                else ()):
            x, dl, dout, dr = (t((rows, 960), dtype) for _ in range(4))
            sc = (1 + 0.1 * t((960,), torch.float32)).to(dtype)
            a = [y.clone().requires_grad_(True) for y in (x, sc)]
            o = rmsnorm(*a, 1e-5)
            got = torch.autograd.grad((o.float() * dout.float()).sum(), a)
            p = [y.clone().requires_grad_(True) for y in (x, sc)]
            o_plain = rmsnorm_plain(*p, 1e-5)
            want = torch.autograd.grad((o_plain.float()
                                        * dout.float()).sum(), p)
            err_norm = _grad_err(got, want)
            fwd_norm = _errors(o.detach(), o_plain.detach(), dname, TOL,
                               False)
            a = [y.clone().requires_grad_(True) for y in (x, dl, sc)]
            r, o = add_rmsnorm(*a, 1e-5)
            got = torch.autograd.grad((r.float() * dr.float()).sum()
                                      + (o.float() * dout.float()).sum(), a)
            p = [y.clone().requires_grad_(True) for y in (x, dl, sc)]
            r_plain, o_plain = add_rmsnorm_plain(*p, 1e-5)
            want = torch.autograd.grad(
                (r_plain.float() * dr.float()).sum()
                + (o_plain.float() * dout.float()).sum(), p)
            err_add = _grad_err(got, want)
            fwd_add = _errors(o.detach(), o_plain.detach(), dname, TOL,
                              False)
            r_equal = torch.equal(r.detach(), r_plain.detach())
            emit({"phase": "kernels", "kernel": "rmsnorm",
                  "check": "rmsnorm and add_rmsnorm gradients vs autograd "
                           "through the plain versions, and the "
                           "Functions' forward vs the plain forward",
                  "dtype": dname, "shape": [rows, 960],
                  "rmsnorm_max_rel_err": err_norm,
                  "add_rmsnorm_max_rel_err": err_add, "tol": TOL[dname],
                  "rmsnorm_forward_max_abs_err": fwd_norm[0],
                  "add_rmsnorm_forward_max_abs_err": fwd_add[0],
                  "forward_bf16_step_excess": [fwd_norm[2], fwd_add[2]],
                  "forward_ok": fwd_norm[3] and fwd_add[3],
                  "add_rmsnorm_r_equal": r_equal})
            if not max(err_norm, err_add) <= TOL[dname]:
                raise AssertionError(f"rmsnorm gradients {dname} {rows}: "
                                     f"{err_norm}, {err_add}")
            if not (fwd_norm[3] and fwd_add[3] and r_equal):
                raise AssertionError(f"rmsnorm Functions' forward {dname} "
                                     f"{rows}: {fwd_norm}, {fwd_add}, r "
                                     f"equal {r_equal}")
            del x, dl, dout, dr, a, p, got, want, o, o_plain, r, r_plain
    return cases


#: the verify round's rows: smollm-360m's 8 rows at positions 32-600
VERIFY_POS = [32, 600, 117, 256, 75, 413, 519, 188]


def chunk_case(dev, dname) -> dict:
    """The batched paged-chunk form at a verify round's shapes (B 8, C = K
    + 1 = 5, H 15, KV 5, hd 64, blocks of 16 of 1024-slot rows, each
    row's pos on the device): against its plain version under the gates,
    each row bit-equal to a one-row call at its pos, and the same data in
    blocks of 32 bit-equal; then timed (in bf16 against the ``cuda_core``
    body too), with ``F.scaled_dot_product_attention`` over the gathered
    KV and a per-row mask as the library call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import paged_gather
    from repro_torch.kernels.flash_attention import (
        paged_chunk_attention, paged_chunk_attention_plain,
        paged_prefill_attention)
    rng = np.random.default_rng(SEED + 8)
    dtype = getattr(torch, dname)
    es = torch.finfo(dtype).bits // 8
    B, C, H, KV, HD, S = 8, 5, 15, 5, 64, 1024
    pos_np = np.asarray(VERIFY_POS, np.int32)
    k = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((B, C, H, HD)).astype(
        np.float32)).to(dev, dtype)
    pos = torch.from_numpy(pos_np).to(dev)
    pools = {}
    for bs in (16, 32):
        nb = S // bs
        tables_np = (rng.permutation(B * nb).reshape(B, nb) + 1).astype(
            np.int32)
        kp = np.zeros((B * nb + 1, bs, KV, HD), np.float32)
        vp = np.zeros((B * nb + 1, bs, KV, HD), np.float32)
        kp[tables_np] = k.reshape(B, nb, bs, KV, HD)
        vp[tables_np] = v.reshape(B, nb, bs, KV, HD)
        pools[bs] = [torch.from_numpy(a).to(dev, dtype) for a in (kp, vp)] + [
            torch.from_numpy(tables_np).to(dev)]
    kp, vp, tables = pools[16]
    out = paged_chunk_attention(q, kp, vp, tables, pos)
    rows_equal = all(torch.equal(out[b], paged_prefill_attention(
        q[b].contiguous(), kp, vp, tables[b].contiguous(), int(pos_np[b])))
        for b in range(B))
    blocks_equal = torch.equal(out, paged_chunk_attention(q, *pools[32][:2],
                                                          pools[32][2], pos))
    emit({"phase": "kernels", "kernel": "paged_chunk_attention",
          "check": "rows bit-equal to one-row calls; blocks of 32 bit-equal "
                   "to blocks of 16", "dtype": dname,
          "rows_equal": rows_equal, "blocks_equal": blocks_equal})
    if not (rows_equal and blocks_equal):
        raise AssertionError(f"paged_chunk_attention {dname}: rows equal to "
                             f"one-row calls {rows_equal}, blocks of 32 "
                             f"equal {blocks_equal}")
    kg = paged_gather(kp, tables).permute(0, 2, 1, 3).contiguous()
    vg = paged_gather(vp, tables).permute(0, 2, 1, 3).contiguous()
    qs = q.permute(0, 2, 1, 3).contiguous()                  # (B,H,C,hd)
    mask = (torch.arange(S, device=dev)[None, None, :]
            <= pos.long()[:, None, None]
            + torch.arange(C, device=dev)[None, :, None])[:, None]
    n_slots = int((pos_np + C).sum())
    n_entries = sum(-(-(int(p) + C) // 16) for p in pos_np)
    n_pairs = int(sum(p + i + 1 for p in pos_np for i in range(C)))
    return _case(
        "paged_chunk_attention", dname,
        {"B": B, "C": C, "H": H, "KV": KV, "hd": HD, "bs": 16,
         "pos": pos_np.tolist()},
        out, paged_chunk_attention_plain(q, kp, vp, tables, pos),
        lambda: paged_chunk_attention(q, kp, vp, tables, pos),
        lambda: paged_chunk_attention_plain(q, kp, vp, tables, pos),
        lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask,
                                               enable_gqa=True),
        # q read, out written; each row's pos + C slots of K and V; its
        # table entries and pos
        2 * B * C * H * HD * es + 2 * n_slots * KV * HD * es
        + 4 * n_entries + 4 * B,
        4 * H * HD * n_pairs,
        prev=(lambda: paged_chunk_attention(q, kp, vp, tables, pos,
                                            _body="cuda_core"))
        if dname == "bfloat16" else None)


#: gemma3-12b's attention: 16 query heads over 8 KV heads of 256, a ring
#: of w = 1024 slots, chunks of 128, rows of max_len 2176
GEMMA = {"H": 16, "KV": 8, "hd": 256, "w": 1024, "C": 128, "max_len": 2176}
#: a decode batch's positions, 5-2000: before, at and past the ring's wrap
GEMMA_DECODE_POS = [5, 300, 1022, 1023, 1024, 1500, 1777, 2000]


def _bounds(nbytes, flops, dtype) -> dict:
    """Both halves of the bound, for the cases that print them."""
    return {"bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "flops_bound_ms": flops / PEAK_FLOPS[dtype] * 1e3}


def gemma_cases(dev) -> list:
    """The attention kernels at gemma3-12b's shapes (hd 256: in bf16 on
    their wide ``mma`` bodies, in float32 on ``cuda_core``).

    ``ring_chunk_attention``, the flash kernel's window form, in float32
    and bfloat16 at pos 0 (no ring key valid), 512 (ring partly filled)
    and 3000 (wrapped): against its plain version under the gates, the
    same ring in blocks of 32 and as a dense one-block ring bit-equal to
    blocks of 16, pos as a (1,) int32 tensor on the card bit-equal to the
    host int (in bf16 on both bodies), and timed (bf16 in turns against
    ``cuda_core``), with ``F.scaled_dot_product_attention`` over
    ``[gathered ring ; chunk]`` and the boolean window mask as the library
    call.  Then the one-row paged prefill (C 128) in bfloat16 at pos
    1024 and 2048, on ``mma`` against ``cuda_core`` in turns, its bits
    the same in blocks of 16, 32 and one dense block, and in float32 at
    pos 1024 on ``cuda_core``; and both decode kernels (B 8, pos 5-2000)
    in bfloat16 over linear rows of 2176 slots and over rings of 1024 (at
    the pos the model clamps to w - 1), on ``mma`` against ``cuda_core``
    in turns, the dense kernel bit-equal to the paged one on the same
    rows, and in float32 over linear rows on ``cuda_core``: as the gemma3
    serve runs launch them.  Each launch is checked on its body."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        dense_decode_attention, dense_decode_attention_plain,
        paged_decode_attention, paged_decode_attention_plain, paged_gather)
    from repro_torch.kernels.flash_attention import (
        paged_prefill_attention, paged_prefill_attention_plain,
        ring_chunk_attention, ring_chunk_attention_plain, ring_positions)
    rng = np.random.default_rng(SEED + 9)
    H, KV, HD, W, C = (GEMMA[k] for k in ("H", "KV", "hd", "w", "C"))
    BS, cases = 16, []

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        es = torch.finfo(dtype).bits // 8
        body = "mma" if dname == "bfloat16" else "cuda_core"
        for pos in (0, 512, 3000):
            nb = W // BS
            ring_k = rng.standard_normal((W, KV, HD)).astype(np.float32)
            ring_v = rng.standard_normal((W, KV, HD)).astype(np.float32)
            table_np = (rng.permutation(nb) + 1).astype(np.int32)
            pools = []
            for ring in (ring_k, ring_v):
                pool = np.zeros((nb + 1, BS, KV, HD), np.float32)
                pool[table_np] = ring.reshape(nb, BS, KV, HD)
                pools.append(t(pool, dtype))
            kp, vp = pools
            table = torch.from_numpy(table_np).to(dev)
            q = t(rng.standard_normal((C, H, HD)), dtype)
            kn = t(rng.standard_normal((C, KV, HD)), dtype)
            vn = t(rng.standard_normal((C, KV, HD)), dtype)
            out = _on_body("ring_chunk_attention", body,
                           lambda: ring_chunk_attention(q, kp, vp, table, kn,
                                                        vn, pos, W))
            # pos read on the device: the host-int call's bits, on both
            # bodies in bf16
            pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
            device_pos_equal = {b: torch.equal(
                out if b == body else ring_chunk_attention(
                    q, kp, vp, table, kn, vn, pos, W, _body=b),
                ring_chunk_attention(q, kp, vp, table, kn, vn, pos_t, W,
                                     _body=b))
                for b in ((body, "cuda_core") if body == "mma" else (body,))}
            # the same ring in blocks of 32 (identity table) and as one
            # dense block of W slots
            k32 = t(ring_k, dtype).reshape(W // 32, 32, KV, HD)
            v32 = t(ring_v, dtype).reshape(W // 32, 32, KV, HD)
            t32 = torch.arange(W // 32, dtype=torch.int32, device=dev)
            blocks_equal = torch.equal(out, ring_chunk_attention(
                q, k32, v32, t32, kn, vn, pos, W))
            dense_equal = torch.equal(out, ring_chunk_attention(
                q, k32.reshape(1, W, KV, HD), v32.reshape(1, W, KV, HD),
                t32[:1], kn, vn, pos, W))
            emit({"phase": "kernels", "kernel": "ring_chunk_attention",
                  "check": "blocks of 32 and a dense one-block ring "
                           "bit-equal to blocks of 16; device pos bit-equal "
                           "to host pos", "dtype": dname, "body": body,
                  "pos": pos, "blocks_equal": blocks_equal,
                  "dense_equal": dense_equal,
                  "device_pos_equal": device_pos_equal})
            if not (blocks_equal and dense_equal
                    and all(device_pos_equal.values())):
                raise AssertionError(f"ring_chunk_attention {dname} pos "
                                     f"{pos}: blocks of 32 equal "
                                     f"{blocks_equal}, dense ring equal "
                                     f"{dense_equal}, device pos equal "
                                     f"{device_pos_equal}")
            kpos = ring_positions(pos, W, C, dev)[None, :]
            qpos = pos + torch.arange(C, device=dev)[:, None]
            valid = (kpos >= 0) & (kpos <= qpos) & (kpos > qpos - W)
            k_all = torch.cat([paged_gather(kp, table[None])[0], kn])
            v_all = torch.cat([paged_gather(vp, table[None])[0], vn])
            k_all = k_all.permute(1, 0, 2)[None].contiguous()
            v_all = v_all.permute(1, 0, 2)[None].contiguous()
            qs = q.permute(1, 0, 2)[None].contiguous()
            n_old = min(pos, W)
            # q read, out written; the ring slots that hold a position
            # and the chunk's keys, K and V; their table entries
            nbytes = (2 * C * H * HD * es + 2 * (n_old + C) * KV * HD * es
                      + 4 * -(-n_old // BS))
            flops = 4 * HD * H * int(valid.sum())
            cases.append(_case(
                "ring_chunk_attention", dname,
                {"C": C, "H": H, "KV": KV, "hd": HD, "bs": BS, "w": W,
                 "pos": pos},
                out, ring_chunk_attention_plain(q, kp, vp, table, kn, vn,
                                                pos, W),
                lambda: ring_chunk_attention(q, kp, vp, table, kn, vn, pos,
                                             W),
                lambda: ring_chunk_attention_plain(q, kp, vp, table, kn, vn,
                                                   pos, W),
                lambda: F.scaled_dot_product_attention(
                    qs, k_all, v_all, attn_mask=valid, enable_gqa=True),
                nbytes, flops,
                prev=(lambda: ring_chunk_attention(
                    q, kp, vp, table, kn, vn, pos, W, _body="cuda_core"))
                if body == "mma" else None,
                extra={"body": body, **_bounds(nbytes, flops, dname)}))

    # the attn layers' prefill at hd 256: bf16 on the wide mma body, timed
    # in turns against the previous cuda_core body, its bits the same in
    # blocks of 16, 32 and one dense block; float32 still on cuda_core
    max_len = GEMMA["max_len"]
    k_rows = rng.standard_normal((max_len, KV, HD)).astype(np.float32)
    v_rows = rng.standard_normal((max_len, KV, HD)).astype(np.float32)
    q_np = rng.standard_normal((C, H, HD)).astype(np.float32)
    layouts = {}
    for bs in (BS, 32, max_len):
        nb = max_len // bs
        table_np = (rng.permutation(nb) + 1).astype(np.int32)
        pools = []
        for rows in (k_rows, v_rows):
            pool = np.zeros((nb + 1, bs, KV, HD), np.float32)
            pool[table_np] = rows.reshape(nb, bs, KV, HD)
            pools.append(pool)
        layouts[bs] = pools + [table_np]
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        es = torch.finfo(dtype).bits // 8
        body = "mma" if dname == "bfloat16" else "cuda_core"
        kp, vp = (t(a, dtype) for a in layouts[BS][:2])
        table = torch.from_numpy(layouts[BS][2]).to(dev)
        q = t(q_np, dtype)
        for p0 in ((1024, 2048) if dname == "bfloat16" else (1024,)):
            out = _on_body("paged_prefill_attention", body,
                           lambda: paged_prefill_attention(q, kp, vp, table,
                                                           p0))
            if dname == "bfloat16":
                others = [paged_prefill_attention(
                    q, t(lay[0], dtype), t(lay[1], dtype),
                    torch.from_numpy(lay[2]).to(dev), p0)
                    for lay in (layouts[32], layouts[max_len])]
                equal = [torch.equal(out, o) for o in others]
                emit({"phase": "kernels", "kernel": "paged_prefill_attention",
                      "check": "hd 256: blocks of 32 and one dense block "
                               "bit-equal to blocks of 16", "dtype": dname,
                      "pos": p0, "blocks_equal": equal[0],
                      "dense_equal": equal[1]})
                if not all(equal):
                    raise AssertionError(f"paged_prefill_attention hd 256 pos "
                                         f"{p0}: blocks of 32 equal "
                                         f"{equal[0]}, one dense block equal "
                                         f"{equal[1]}")
            n_slots = p0 + C
            kc = paged_gather(kp, table[None])[0, :n_slots].permute(1, 0, 2)
            vc = paged_gather(vp, table[None])[0, :n_slots].permute(1, 0, 2)
            kc, vc = kc[None].contiguous(), vc[None].contiguous()
            qs = q.permute(1, 0, 2)[None].contiguous()
            cmask = (torch.arange(n_slots, device=dev)[None, :]
                     <= p0 + torch.arange(C, device=dev)[:, None])
            nbytes = (2 * C * H * HD * es + 2 * n_slots * KV * HD * es
                      + 4 * -(-n_slots // BS))
            flops = 4 * H * HD * sum(p0 + i + 1 for i in range(C))
            cases.append(_case(
                "paged_prefill_attention", dname,
                {"C": C, "H": H, "KV": KV, "hd": HD, "bs": BS, "pos": p0},
                out, paged_prefill_attention_plain(q, kp, vp, table, p0),
                lambda: paged_prefill_attention(q, kp, vp, table, p0),
                lambda: paged_prefill_attention_plain(q, kp, vp, table, p0),
                lambda: F.scaled_dot_product_attention(
                    qs, kc, vc, attn_mask=cmask, enable_gqa=True),
                nbytes, flops,
                prev=(lambda: paged_prefill_attention(
                    q, kp, vp, table, p0, _body="cuda_core"))
                if body == "mma" else None,
                extra={"body": body, **_bounds(nbytes, flops, dname)}))

    # ... and the decode kernels over linear rows and over rings (bf16 on
    # the wide mma body, against cuda_core in turns; the dense cache holds
    # the paged rows' own K/V, and the two kernels must give the same
    # bits), and over linear rows in float32 on cuda_core
    B = len(GEMMA_DECODE_POS)
    pos_np = np.asarray(GEMMA_DECODE_POS, np.int32)
    qd_np = rng.standard_normal((B, H, HD)).astype(np.float32)
    for dname, ring in (("bfloat16", False), ("bfloat16", True),
                        ("float32", False)):
        dtype = getattr(torch, dname)
        es = torch.finfo(dtype).bits // 8
        body = "mma" if dname == "bfloat16" else "cuda_core"
        qd = t(qd_np, dtype)
        s_len = W if ring else max_len
        kpos_np = np.minimum(pos_np, s_len - 1)   # the model's clamp
        pos = torch.from_numpy(kpos_np).to(dev)
        n_keys = int(kpos_np.sum() + B)
        mask = (torch.arange(s_len, device=dev)[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        nbs = s_len // BS
        nbp = B * nbs + 1
        kpool = t(rng.standard_normal((nbp, BS, KV, HD)), dtype)
        vpool = t(rng.standard_normal((nbp, BS, KV, HD)), dtype)
        tables = torch.from_numpy((rng.permutation(nbp - 1).reshape(
            B, nbs) + 1).astype(np.int32)).to(dev)
        kc = paged_gather(kpool, tables).contiguous()     # (B, S, KV, hd)
        vc = paged_gather(vpool, tables).contiguous()
        kt = kc.permute(0, 2, 1, 3).contiguous()
        vt = vc.permute(0, 2, 1, 3).contiguous()
        shape = {"B": B, "H": H, "KV": KV, "hd": HD, "bs": BS,
                 "slots": s_len, "ring": ring, "pos": pos_np.tolist(),
                 "kernel_pos": kpos_np.tolist()}
        paged = _on_body("paged_decode_attention", body,
                         lambda: paged_decode_attention(qd, kpool, vpool,
                                                        tables, pos))
        dense = _on_body("dense_decode_attention", body,
                         lambda: dense_decode_attention(qd, kc, vc, pos))
        equal = torch.equal(paged, dense)
        emit({"phase": "kernels", "kernel": "dense_decode_attention",
              "check": "hd 256: dense bit-equal to paged on the same rows",
              "dtype": dname, "ring": ring, "equal": equal})
        if not equal:
            raise AssertionError(f"decode hd 256 {dname} ring {ring}: the "
                                 f"dense kernel's bits differ from the "
                                 f"paged kernel's")
        nbytes_paged = (2 * B * H * HD * es + 2 * n_keys * KV * HD * es
                        + 4 * (n_keys // BS + B) + 4 * B)
        nbytes_dense = 2 * B * H * HD * es + 2 * n_keys * KV * HD * es + 4 * B
        flops = 4 * H * HD * n_keys
        cases.append(_case(
            "paged_decode_attention", dname, shape, paged,
            paged_decode_attention_plain(qd, kpool, vpool, tables, pos),
            lambda: paged_decode_attention(qd, kpool, vpool, tables, pos),
            lambda: paged_decode_attention_plain(qd, kpool, vpool, tables,
                                                 pos),
            lambda: F.scaled_dot_product_attention(
                qd[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True),
            nbytes_paged, flops,
            prev=(lambda: paged_decode_attention(
                qd, kpool, vpool, tables, pos, _body="cuda_core"))
            if body == "mma" else None, extra={"body": body}))
        cases.append(_case(
            "dense_decode_attention", dname, {**shape, "S": s_len}, dense,
            dense_decode_attention_plain(qd, kc, vc, pos),
            lambda: dense_decode_attention(qd, kc, vc, pos),
            lambda: dense_decode_attention_plain(qd, kc, vc, pos),
            lambda: F.scaled_dot_product_attention(
                qd[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True),
            nbytes_dense, flops,
            prev=(lambda: dense_decode_attention(qd, kc, vc, pos,
                                                 _body="cuda_core"))
            if body == "mma" else None, extra={"body": body}))
    return cases


def _on_body(kernel: str, body: str, fn):
    """``fn()``, which must launch ``kernel`` once, on ``body``."""
    from repro_torch.kernels import _build
    before = dict(_build.bodies[kernel])
    out = fn()
    want = {k: n + (k == body) for k, n in before.items()}
    if _build.bodies[kernel] != want:
        raise AssertionError(f"{kernel}: launches by body went from "
                             f"{before} to {_build.bodies[kernel]}, expected "
                             f"one on {body}")
    return out


def launch_floor(dev) -> list:
    """The empty kernel's device time and time per back-to-back call, at
    one block and at the grid of the decode scan (8 rows of
    falcon-mamba-7b), in blocks of 128 threads: the least any launch of
    such a grid costs, beside which the kernels of a few microseconds
    are judged."""
    from repro_torch.kernels.launch_floor import empty
    from repro_torch.kernels.selective_scan import scan_blocks, scan_lanes
    rows = []
    for blocks in (1, scan_blocks(8, 8192, scan_lanes(8, 8192, 16))):
        empty(dev, blocks)
        row = {"phase": "kernels", "kernel": "empty",
               "check": "launch floor (no TPU kernel; not listed)",
               "blocks": blocks, "threads": 128,
               "ms": device_ms(lambda: empty(dev, blocks)),
               "call_ms": call_ms(lambda: empty(dev, blocks))}
        emit(row)
        rows.append(row)
    return rows


def scan_cases(dev) -> list:
    """The selective scan in float32 at falcon-mamba-7b's shapes: a decode
    step of 8 rows and a prefill chunk of 128 steps, both with the state
    updated in place as the model runs them, and a ragged case (DI and T
    off the kernel's tiles, B and C as strided column slices).  The
    model's body (``state_lanes``) is timed in turns with the previous
    one (``cuda_core``), whose ``h_T`` it must equal bit for bit."""
    import torch
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_plain)
    rng = np.random.default_rng(SEED + 4)
    cases = []
    for b, t, di, ds, aliased, strided in ((8, 1, 8192, 16, True, False),
                                           (1, 128, 8192, 16, True, False),
                                           (2, 100, 300, 8, False, True)):
        def f32(shape):
            return torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).to(dev)
        dt = torch.nn.functional.softplus(f32((b, t, di)))
        x, h0 = f32((b, t, di)), f32((b, di, ds))
        bm, cm = f32((b, t, ds)), f32((b, t, ds))
        a_neg = -f32((di, ds)).abs()
        if strided:       # x_proj's output layout: [dt_r | B | C]
            proj = torch.cat([f32((b, t, 5)), bm, cm], dim=-1)
            bm, cm = proj[..., 5:5 + ds], proj[..., 5 + ds:]
        want_y, want_h = selective_scan_plain(dt, bm, cm, x, a_neg, h0)
        h, hp = h0.clone(), h0.clone()
        got_y, got_h = selective_scan(dt, bm, cm, x, a_neg, h,
                                      h_out=h if aliased else None)
        if aliased and got_h is not h:
            raise AssertionError("selective_scan: h_out=h0 did not update "
                                 "the state in place")
        prev_y, prev_h = selective_scan(dt, bm, cm, x, a_neg, hp,
                                        h_out=hp if aliased else None,
                                        _body="cuda_core")
        shape = {"B": b, "T": t, "DI": di, "DS": ds, "h_in_place": aliased,
                 "strided_bc": strided}
        h_equal = torch.equal(got_h, prev_h)
        emit({"phase": "kernels", "kernel": "selective_scan",
              "check": "h_T of state_lanes bit-equal to cuda_core's",
              "shape": shape, "equal": h_equal,
              "y_max_abs_diff": (got_y - prev_y).abs().max().item()})
        if not h_equal:
            raise AssertionError(f"selective_scan {shape}: state_lanes' h_T "
                                 f"differs from the previous body's")
        hs = h.clone()    # the timed calls carry this state on, in place

        def kernel(hs=hs, args=(dt, bm, cm, x, a_neg)):
            return selective_scan(*args, hs, h_out=hs if aliased else None)

        def prev(hs=hs, args=(dt, bm, cm, x, a_neg)):
            return selective_scan(*args, hs, h_out=hs if aliased else None,
                                  _body="cuda_core")

        def plain(hs=hs, args=(dt, bm, cm, x, a_neg)):
            return selective_scan_plain(*args, hs,
                                        h_out=hs if aliased else None)
        issue_ms = (b * t * di * ds * SCAN_INSTR_PER_UPDATE
                    / ISSUE_PER_S * 1e3)
        cases.append(_case(
            "selective_scan", "float32", shape,
            torch.cat([got_y.flatten(), got_h.flatten()]),
            torch.cat([want_y.flatten(), want_h.flatten()]),
            kernel, plain, None,
            # dt, x, y once per (b, t, d); B, C per (b, t); A once; h read
            # and written
            4 * (3 * b * t * di + 2 * b * t * ds + di * ds + 2 * b * di * ds),
            # per (b, t, d): dt*x, then per state element a multiply, an
            # exp, three more multiplies and two adds (an exp counted as
            # one f32 operation)
            b * t * di * (1 + 7 * ds),
            relative=True,
            library_note="none: no single PyTorch call computes the "
                         "recurrence",
            prev=prev, prev_out=torch.cat([prev_y.flatten(),
                                           prev_h.flatten()]),
            extra={"issue_bound_ms": issue_ms,
                   "instr_per_update": SCAN_INSTR_PER_UPDATE}))
    return cases


# ---------------------------------------------------------------------------
# phases 4-5: the engine
# ---------------------------------------------------------------------------
def _to(params, dev):
    if isinstance(params, dict):
        return {k: _to(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [_to(v, dev) for v in params]
    return params if params is None else params.to(dev)


def _trace(rng, n, lo, hi, vocab):
    return [rng.integers(1, vocab, int(m)).tolist()
            for m in rng.integers(lo, hi + 1, n)]


def _top2_gap(model, params, tokens, dev):
    """Top-2 logit gap of the next token after ``tokens`` (plain path)."""
    import torch
    from repro_torch.models.kvcache import PagedCache
    max_len = max(1024, -(-(len(tokens) + 1) // 16) * 16)
    pc = PagedCache(model.cfg, max_rows=1, max_len=max_len, device=dev)
    caches = pc.struct(model.dtype)
    pc.admit(0, len(tokens))
    prompt = torch.tensor([tokens[:-1]], dtype=torch.int32, device=dev)
    if len(tokens) > 1:
        model.paged_prefill_chunk(params, caches, prompt, 0, 0, pc.meta(row=0))
    logits, _ = model.paged_decode_step(
        params, caches,
        {"token": torch.tensor([[tokens[-1]]], dtype=torch.int32, device=dev),
         "pos": torch.tensor([len(tokens) - 1], dtype=torch.int32,
                             device=dev)}, pc.meta())
    top = torch.topk(logits[0, -1, :model.cfg.vocab_size].float(), 2)
    return (top.values[0] - top.values[1]).item(), top.indices.tolist()


def _first_divergence(cfg, params_cpu, fmt, prompts, got_all, ref_all):
    """Where the card's stream first leaves the CPU's, with the plain
    path's top-2 logit gap there."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.models.quantize import quantize_params
    cpu = torch.device("cpu")
    for rid, ref in sorted(ref_all.items()):
        got = got_all.get(rid, [])
        if got != ref:
            i = next((j for j, (a, b) in enumerate(zip(got, ref)) if a != b),
                     min(len(got), len(ref)))
            gap, top = _top2_gap(Model(cfg, qformat=fmt, device=cpu),
                                 quantize_params(params_cpu, fmt),
                                 prompts[rid] + ref[:i], cpu)
            return {"request": rid, "index": i, "cuda": got[i:i + 4],
                    "cpu": ref[i:i + 4], "plain_top2_gap": gap,
                    "plain_top2": top}
    return None


def _parity_config(dev, cfg, label, runs, prompts, max_len) -> dict:
    """One trace through each (engine, format, speculation) of ``runs`` on
    the card and on the CPU, from the same f32 weights (each engine packs
    its own).  Speculation is None, an int K (n-gram drafts) or
    ``"model"`` (a 2-layer smollm-360m draft at full width, float32, with
    weights from its own seed, drawn on the CPU so both devices hold the
    same).  A speculative run's card stream must also equal the card's
    non-speculative stream of the same engine and format, which ``runs``
    must hold before it."""
    import torch
    from repro_torch.config import uniform
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import (PagedServingEngine, Request,
                                            ServingEngine)
    from repro_torch.serving.speculative import ModelDraft
    cpu = torch.device("cpu")
    params_cpu = Model(cfg, device=cpu).init(
        torch.Generator().manual_seed(SEED))
    params_gpu = _to(params_cpu, dev)
    draft_cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=2,
                                    block_pattern=uniform("attn", 2),
                                    dtype="float32")

    def speculative(spec, d):
        if spec == "model":
            return {"k": 4, "provider": ModelDraft(draft_cfg, seed=SEED + 7,
                                                   device=d)}
        return spec
    engines = {
        "paged": lambda p, d, fmt, spec: PagedServingEngine(
            cfg, p, max_rows=4, max_len=max_len, block_size=16,
            prefill_chunk=128, decode_steps=4, quantization=fmt,
            speculative=speculative(spec, d), device=d),
        "slot": lambda p, d, fmt, spec: ServingEngine(
            cfg, p, max_batch=4, cache_len=max_len, prefill_chunk=128,
            decode_steps=4, quantization=fmt,
            speculative=speculative(spec, d), device=d)}
    streams, results = {}, []
    t0 = time.perf_counter()
    for engine, fmt, spec in runs:
        for name, d, p in (("cuda", dev, params_gpu),
                           ("cpu", cpu, params_cpu)):
            eng = engines[engine](p, d, fmt, spec)
            for i, pr in enumerate(prompts):
                eng.submit(Request(i, list(pr), max_new_tokens=16))
            streams[engine, fmt, spec, name] = {r.id: r.out_tokens
                                                for r in eng.run()}
        got = streams[engine, fmt, spec, "cuda"]
        ref = streams[engine, fmt, spec, "cpu"]
        run = {"engine": engine, "quantization": fmt, "speculative": spec,
               "equal": got == ref,
               "tokens": sum(len(x) for x in ref.values())}
        if spec is not None:
            run.update(
                equal_to_plain=got == streams[engine, fmt, None, "cuda"],
                spec_gated_off=eng.spec_gated_off,
                spec_rounds=eng.spec_rounds,
                acceptance_rate=eng.acceptance_rate,
                spec_accept_mean=eng.spec_accept_mean())
            run["equal"] = run["equal"] and run["equal_to_plain"]
        if got != ref:
            run["first_divergence"] = _first_divergence(
                cfg, params_cpu, fmt, prompts, got, ref)
        results.append(run)
    slot_is_paged = {str(fmt): streams["slot", fmt, None, "cuda"]
                     == streams["paged", fmt, None, "cuda"]
                     for engine, fmt, spec in runs
                     if engine == "slot" and spec is None}
    res = {"phase": "parity", "config": label,
           "requests": len(prompts), "runs": results,
           "card_slot_equals_paged": slot_is_paged,
           "equal": all(r["equal"] for r in results)
           and all(slot_is_paged.values()),
           "seconds": time.perf_counter() - t0}
    emit(res)
    if not res["equal"]:
        raise AssertionError(f"{label}: token streams differ: card against "
                             f"CPU, slot against paged engine on the card, "
                             f"or speculative against plain decode on the "
                             f"card")
    return res


def parity(dev) -> list:
    """smollm-360m through both engines, unquantized and quantized, and
    with speculation (n-gram drafts on both engines and with int8 weights,
    a model draft on the paged engine; K = 4), then falcon-mamba-7b and
    gemma3-12b (one ``swa`` layer with its published window of 1024, one
    ``attn``) through both engines and once with ``speculative=4``, which
    they must gate off; each at full width and 2 layers in float32, on
    the card and on the CPU.  gemma3's prompts (1040-1200 tokens) all
    wrap the ring before their first decode step."""
    from repro_torch.config import uniform
    from repro_torch.configs import get_config
    smollm = dataclasses.replace(get_config("smollm-360m"), n_layers=2,
                                 block_pattern=uniform("attn", 2),
                                 dtype="float32")
    mamba = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2,
                                block_pattern=uniform("mamba1", 2),
                                dtype="float32")
    gemma = dataclasses.replace(get_config("gemma3-12b"), n_layers=2,
                                block_pattern=("swa", "attn"),
                                dtype="float32")
    smollm_res = _parity_config(
        dev, smollm, "smollm-360m, 2 layers, float32",
        (("paged", None, None), ("paged", "int8", None),
         ("paged", "int4", None), ("slot", None, None),
         ("slot", "int8", None), ("paged", None, 4), ("slot", None, 4),
         ("paged", "int8", 4), ("paged", None, "model")),
        _trace(np.random.default_rng(SEED + 1), 4, 20, 150,
               smollm.vocab_size), 256)
    # prompts of at most 64 tokens keep the CPU's side short
    mamba_res = _parity_config(
        dev, mamba, "falcon-mamba-7b, 2 layers, float32",
        (("paged", None, None), ("slot", None, None), ("paged", None, 4)),
        _trace(np.random.default_rng(SEED + 5), 4, 20, 64,
               mamba.vocab_size), 128)
    gemma_res = _parity_config(
        dev, gemma, "gemma3-12b, 2 layers (swa, attn), float32",
        (("paged", None, None), ("slot", None, None), ("paged", None, 4)),
        _trace(np.random.default_rng(SEED + 10), 3, 1040, 1200,
               gemma.vocab_size), 1280)
    spec_runs = [r for r in smollm_res["runs"] if r["speculative"]]
    gated = [r for res in (mamba_res, gemma_res) for r in res["runs"]
             if r["speculative"]]
    if (any(r["spec_gated_off"] or r["spec_rounds"] == 0 for r in spec_runs)
            or not all(r["spec_gated_off"] and r["spec_rounds"] == 0
                       for r in gated)):
        raise AssertionError(f"speculation: smollm runs {spec_runs} must "
                             f"speculate, falcon-mamba and gemma3 runs "
                             f"{gated} must gate it off")
    return [smollm_res, mamba_res, gemma_res]


def _timed(base):
    """``base`` engine class that splits wall time between prefill
    chunks and macro-steps or verify rounds (``decode_s`` holds the
    device forward and its host sync; ``round_s`` a whole verify round,
    the drafting included)."""
    import torch

    class Timed(base):
        prefill_s = decode_s = round_s = 0.0
        macro_steps = decode_iters = prefill_calls = verify_rounds = 0

        def _prefill_row(self, row, toks, pos0):
            t0 = time.perf_counter()
            super()._prefill_row(row, toks, pos0)
            torch.cuda.synchronize()
            self.prefill_s += time.perf_counter() - t0
            self.prefill_calls += 1

        def _forward_steps(self, tokens, pos, budgets, k):
            t0 = time.perf_counter()
            out = super()._forward_steps(tokens, pos, budgets, k)
            self.decode_s += time.perf_counter() - t0
            self.macro_steps += 1
            self.decode_iters += k
            return out

        def _forward_verify(self, tokens, pos, budgets):
            t0 = time.perf_counter()
            out = super()._forward_verify(tokens, pos, budgets)
            self.decode_s += time.perf_counter() - t0
            self.verify_rounds += 1
            return out

        def _spec_tail(self, *args):
            t0 = time.perf_counter()
            out = super()._spec_tail(*args)
            self.round_s += time.perf_counter() - t0
            return out

    return Timed


def projection_bytes(params) -> int:
    """Bytes of the projection weights (``QUANT_KEYS``), packed or not."""
    from repro_torch.models.quantize import QUANT_KEYS, is_quantized
    if isinstance(params, list):
        return sum(projection_bytes(v) for v in params)
    if not isinstance(params, dict):
        return 0
    total = 0
    for key, val in params.items():
        if key in QUANT_KEYS:
            leaves = val.values() if is_quantized(val) else [val]
            total += sum(a.numel() * a.element_size() for a in leaves)
        else:
            total += projection_bytes(val)
    return total


def expected_launches(cfg, slot: bool, qformat, iters: int,
                      chunks: int, names, rounds: int = 0) -> tuple:
    """Kernel launches a run of ``iters`` decode iterations, ``chunks``
    prefill chunks and ``rounds`` verify rounds implies: per attn or swa
    layer two rmsnorms (one without an MLP), one decode attention, one
    prefill attention a chunk (the ring form for a windowed swa layer,
    the paged prefill for the others) or one batched chunk attention a
    verify round and, packed, 7 quant matmuls (4 attention, 3 MLP); per
    Mamba1 layer one rmsnorm and one scan; one final rmsnorm per decode
    iteration and per verify round.  Every rmsnorm but the first of a
    stack takes its residual add as a delta (``add_norm``); the final
    norm takes the last block's.  Returns (launches by kernel,
    rmsnorm's launches by body)."""
    n_swa = cfg.block_pattern.count("swa")
    n_ring = n_swa if cfg.window else 0
    n_attn = cfg.block_pattern.count("attn") + n_swa
    n_mamba = cfg.block_pattern.count("mamba1")
    n_mlp = n_attn if cfg.mlp_kind != "none" else 0
    expect = dict.fromkeys(names, 0)
    norms = n_attn + n_mamba + n_mlp
    heads = iters + rounds        # forwards that end in the final norm
    expect["rmsnorm"] = (norms + 1) * heads + norms * chunks
    norm_bodies = {"add_norm": norms * heads + (norms - 1) * chunks,
                   "norm": heads + chunks, "cuda_core": 0}
    expect["paged_prefill_attention"] = (n_attn - n_ring) * chunks
    expect["ring_chunk_attention"] = n_ring * chunks
    expect["paged_chunk_attention"] = n_attn * rounds
    expect["dense_decode_attention" if slot
           else "paged_decode_attention"] = n_attn * iters
    expect["selective_scan"] = n_mamba * (iters + chunks)
    if qformat:
        expect[f"quant_matmul_{qformat}"] = (4 * n_attn + 3 * n_mlp) * (
            heads + chunks)
    return expect, {"rmsnorm": norm_bodies}


def main_bodies(cfg) -> dict:
    """``MAIN_BODY`` with each of ``cfg``'s attention kernels on the body
    ``ATTN_BODY`` fixes for it; raises if a wrapper's rule would send the
    config's launches elsewhere."""
    from repro_torch.device import torch_dtype
    from repro_torch.kernels.decode_attention import decode_body
    from repro_torch.kernels.flash_attention import prefill_body, ring_body
    if not cfg.n_kv_heads:
        return MAIN_BODY
    dtype = torch_dtype(cfg.dtype)
    rules = {"prefill_body": prefill_body(dtype, cfg.head_dim),
             "ring_body": ring_body(dtype, cfg.head_dim),
             "decode_body": decode_body(dtype, cfg.head_dim,
                                        cfg.n_heads // cfg.n_kv_heads)}
    fixed = ATTN_BODY.get(cfg.name, {})
    bodies = {k: fixed.get(k, "mma") for k in ATTN_RULE}
    named = {k: rules[rule] for k, rule in ATTN_RULE.items()}
    if named != bodies:
        raise AssertionError(f"{cfg.name}: the wrappers' rules name the "
                             f"bodies {named}, expected {bodies}")
    return {**MAIN_BODY, **{k: (b,) for k, b in bodies.items()}}


def serve_run(name, cls, cfg, kw, prompts, dev, ref=None, n_new=64,
              params=None, ref_key="share_equal_to_bf16_paged") -> tuple:
    """One serve run at full width and depth: a warm-up engine (cuBLAS
    handles, allocator pools; its launches are not counted), then the
    measured engine on the same parameters (``params``, or the warm-up
    engine's own draw).  Launch counts are reset just before the run and
    read just after, and must equal what the run's decode iterations and
    prefill chunks (and verify rounds) imply.  ``ref``: a reference run's
    streams on the same requests, for the share of equal tokens, printed
    under ``ref_key``."""
    import gc
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import Request, ServingEngine
    t_call = time.perf_counter()
    timed_cls = _timed(cls)
    warm = timed_cls(cfg, params, **kw)
    warm.submit(Request(-1, list(range(1, 40)), max_new_tokens=4))
    warm.run()
    eng = timed_cls(cfg, warm.params, **kw)
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    for i, pr in enumerate(prompts):
        eng.submit(Request(i, pr, max_new_tokens=n_new))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    bodies = {k: dict(v) for k, v in _build.bodies.items()}
    iters, chunks = eng.decode_iters, eng.prefill_calls
    rounds = eng.verify_rounds
    expect, expect_bodies = expected_launches(
        cfg, issubclass(cls, ServingEngine), eng.quantization, iters, chunks,
        launches, rounds)
    streams = {r.id: r.out_tokens for r in done}
    res = {"phase": "serve", "run": name,
           "engine": cls.__name__, "quantization": eng.quantization,
           "config": f"{cfg.name}, {cfg.n_layers} layers, {cfg.dtype}",
           "requests": len(prompts), "finished": len(done),
           "prompt_tokens": sum(len(p) for p in prompts),
           "prefill_tokens": eng.prefill_tokens,
           "generated_tokens": eng.tokens_generated,
           "wall_s": wall, "prefill_s": eng.prefill_s,
           "decode_s": eng.decode_s,
           "prefill_tok_per_s": eng.prefill_tokens / eng.prefill_s,
           "decode_tok_per_s": eng.tokens_generated / eng.decode_s,
           "macro_steps": eng.macro_steps, "decode_iters": iters,
           "ms_per_macro_step": (eng.decode_s / eng.macro_steps * 1e3
                                 if eng.macro_steps else None),
           "prefill_calls": chunks,
           "n_host_syncs": eng.n_host_syncs,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "projection_weight_bytes": projection_bytes(eng.params),
           "n_preemptions": getattr(eng, "n_preemptions", None),
           "launches": launches, "launches_expected": expect,
           "bodies": bodies, "bodies_expected": expect_bodies}
    if eng.spec is not None:
        res.update(
            speculative_k=eng.spec.k, verify_rounds=rounds,
            acceptance_rate=eng.acceptance_rate,
            spec_accept_mean=eng.spec_accept_mean(),
            host_syncs_per_token=eng.n_host_syncs / eng.tokens_generated,
            ms_per_verify_round=eng.decode_s / rounds * 1e3,
            round_s=eng.round_s,
            round_tok_per_s=eng.tokens_generated / eng.round_s)
    if ref is not None:
        pairs = [(a, b) for rid, toks in streams.items()
                 for a, b in zip(toks, ref[rid])]
        res[ref_key] = sum(a == b for a, b in pairs) / len(pairs)
    res["seconds"] = time.perf_counter() - t_call   # warm-up included
    emit(res)
    bad = [r.id for r in done
           if len(r.out_tokens) != n_new
           or not all(0 <= t < cfg.vocab_size for t in r.out_tokens)]
    if len(done) != len(prompts) or bad or eng.rejected:
        raise AssertionError(f"serve {name}: {len(done)}/{len(prompts)} "
                             f"finished, bad streams {bad}, rejected "
                             f"{[r.id for r in eng.rejected]}")
    if launches != expect or any(launches[k] == 0
                                 for k, v in expect.items() if v):
        raise AssertionError(f"serve {name}: kernel launches {launches}, "
                             f"expected {expect}")
    # every serve run is bf16: each launch of a kernel with more than one
    # body must have taken its main body (the attention kernels' as
    # ATTN_BODY fixes it, the scan's state_lanes, rmsnorm's add_norm or norm),
    # and rmsnorm's must split between those two as the run implies
    bodies_main = main_bodies(cfg)

    def on_main(k, b):
        main = bodies_main.get(k, ("mma",))
        return (sum(b[x] for x in main) == launches[k]
                and all(n == 0 for x, n in b.items() if x not in main))
    if not all(on_main(k, b) for k, b in bodies.items()) or any(
            bodies[k] != v for k, v in expect_bodies.items()):
        raise AssertionError(f"serve {name}: launches by body {bodies}, "
                             f"expected every launch on a body of "
                             f"{bodies_main} (else mma), and "
                             f"{expect_bodies}")
    return res, streams, eng


def serve(dev) -> dict:
    """smollm-360m: the bf16 paged run of 16 requests and its decode
    profile, then the slot engine and the int8 / int4 paged engine on its
    first 8 requests; then falcon-mamba-7b (``serve_mamba``).  Returns
    each run's launch counts."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import PagedServingEngine, ServingEngine
    cfg = get_config("smollm-360m")
    kw = dict(max_rows=8, max_len=1024, block_size=16, prefill_chunk=128,
              decode_steps=16, seed=SEED, device=dev)
    prompts = _trace(np.random.default_rng(SEED + 2), 16, 32, 512,
                     cfg.vocab_size)
    res, ref, eng = serve_run("paged_bf16", PagedServingEngine, cfg, kw,
                              prompts, dev)
    launches = {"paged_bf16": res["launches"]}
    profile_decode(cfg, eng.params, kw, dev, label="paged_bf16")
    with previous_body("paged_decode_attention"):
        profile_decode(cfg, eng.params, kw, dev,
                       label="paged_bf16, previous decode body")
    with previous_body("rmsnorm"):
        profile_decode(cfg, eng.params, kw, dev,
                       label="paged_bf16, previous rmsnorm")
    profile_prefill(cfg, eng.params, kw, dev, label="paged_bf16")
    with previous_body("paged_prefill_attention"):
        profile_prefill(cfg, eng.params, kw, dev,
                        label="paged_bf16, previous prefill body")
    with previous_body("rmsnorm"):
        profile_prefill(cfg, eng.params, kw, dev,
                        label="paged_bf16, previous rmsnorm")
    del eng
    slot_kw = dict(max_batch=8, cache_len=1024, prefill_chunk=128,
                   decode_steps=16, seed=SEED, device=dev)
    # the last run repeats the bf16 paged engine on the same 8 requests,
    # so each quantized or slot run has an equal-sized bf16 neighbour in
    # this process
    for name, cls, run_kw in (
            ("dense_bf16", ServingEngine, slot_kw),
            ("paged_int8", PagedServingEngine, dict(kw, quantization="int8")),
            ("paged_int4", PagedServingEngine, dict(kw, quantization="int4")),
            ("paged_bf16_8", PagedServingEngine, kw)):
        gc.collect()
        torch.cuda.empty_cache()
        res, streams, eng = serve_run(name, cls, cfg, run_kw, prompts[:8],
                                      dev, ref=ref)
        launches[name] = res["launches"]
        if name == "paged_bf16_8":
            streams_8 = streams
        if name in ("paged_int8", "paged_int4"):
            fmt = run_kw["quantization"]
            profile_decode(cfg, eng.params, run_kw, dev, label=name)
            with previous_body(f"quant_matmul_{fmt}"):
                profile_decode(cfg, eng.params, run_kw, dev,
                               label=f"{name}, previous {fmt} body")
        del eng
    # draft-verify speculation (K = 4, n-gram drafts) on the same 8
    # requests, with the share of tokens equal to paged_bf16_8's (not
    # gated: in bf16 the chunk kernel and the decode kernel round
    # differently, and random 32-layer weights amplify that)
    for name, cls, run_kw in (
            ("paged_spec", PagedServingEngine, dict(kw, speculative=4)),
            ("dense_spec", ServingEngine, dict(slot_kw, speculative=4))):
        gc.collect()
        torch.cuda.empty_cache()
        res, _, eng = serve_run(name, cls, cfg, run_kw, prompts[:8], dev,
                                ref=streams_8,
                                ref_key="share_equal_to_paged_bf16_8")
        launches[name] = res["launches"]
        # one batched chunk attention a layer a round (32 on smollm)
        if res["launches"]["paged_chunk_attention"] != cfg.n_layers * res[
                "verify_rounds"] or res["verify_rounds"] == 0:
            raise AssertionError(f"serve {name}: {res['verify_rounds']} "
                                 f"verify rounds, batched chunk attention "
                                 f"launched {res['launches']}")
        if name == "paged_spec":
            profile_verify(cfg, eng.params, run_kw, dev, label=name)
        del eng
    del res, ref, streams, streams_8
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(serve_mamba(dev))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(serve_gemma(dev))
    return launches


def serve_gemma(dev) -> dict:
    """gemma3-12b at full width and depth (48 layers, 40 ``swa`` with the
    1024-slot ring and 8 ``attn``; about 23.5 GB of bf16 weights drawn on
    the card from the seed): 8 requests of 256-2048 tokens (six past the
    window) through ``PagedServingEngine`` and its decode and prefill
    profiles (prompts past the window, so both windows run the wrapped
    ring), both windows again with the previous (``cuda_core``) body of
    the paged decode or the paged prefill, the prefill window with the
    previous body of the ring form, then the same 8 through
    ``ServingEngine`` on the same weights, with its share of tokens equal
    to the paged run's.  Every paged-prefill, ring-form and decode launch
    of the serve runs takes the wide ``mma`` body (hd 256).  Returns each
    run's launch counts."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import PagedServingEngine, ServingEngine
    cfg = get_config("gemma3-12b")
    max_len = GEMMA["max_len"]
    kw = dict(max_rows=8, max_len=max_len, block_size=16, prefill_chunk=128,
              decode_steps=16, seed=SEED, device=dev)
    prompts = _trace(np.random.default_rng(SEED + 1), 8, 256, 2048,
                     cfg.vocab_size)
    if sum(len(p) > cfg.window for p in prompts) < 4:
        raise AssertionError("the gemma3 trace must hold at least four "
                             "prompts past the window")
    res, ref, eng = serve_run("gemma_paged_bf16", PagedServingEngine, cfg,
                              kw, prompts, dev)
    launches = {"gemma_paged_bf16": res["launches"]}
    profile_decode(cfg, eng.params, kw, dev, label="gemma_paged_bf16",
                   prompt_len=1100)
    profile_prefill(cfg, eng.params, kw, dev, label="gemma_paged_bf16",
                    prompt_len=1153)
    with previous_body("paged_decode_attention"):
        profile_decode(cfg, eng.params, kw, dev,
                       label="gemma_paged_bf16, previous decode body",
                       prompt_len=1100)
    with previous_body("paged_prefill_attention"):
        profile_prefill(cfg, eng.params, kw, dev,
                        label="gemma_paged_bf16, previous prefill body",
                        prompt_len=1153)
    with previous_body("ring_chunk_attention"):
        profile_prefill(cfg, eng.params, kw, dev,
                        label="gemma_paged_bf16, previous ring body",
                        prompt_len=1153)
    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    res, _, eng = serve_run(
        "gemma_dense_bf16", ServingEngine, cfg,
        dict(max_batch=8, cache_len=max_len, prefill_chunk=128,
             decode_steps=16, seed=SEED, device=dev), prompts, dev, ref=ref,
        params=params)
    launches["gemma_dense_bf16"] = res["launches"]
    return launches


def serve_mamba(dev) -> dict:
    """falcon-mamba-7b at full width and depth (64 Mamba1 layers, about
    14.5 GB of bf16 weights drawn from the seed): 8 requests through
    ``PagedServingEngine`` and its decode and prefill-chunk profiles,
    both again under the previous scan body and under the previous
    rmsnorm, then the same 8 through
    ``ServingEngine`` on the same weights, with its share of tokens equal
    to the paged run's.  Returns each run's launch counts."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import PagedServingEngine, ServingEngine
    cfg = get_config("falcon-mamba-7b")
    kw = dict(max_rows=8, max_len=1024, block_size=16, prefill_chunk=128,
              decode_steps=16, seed=SEED, device=dev)
    prompts = _trace(np.random.default_rng(SEED + 2), 8, 32, 512,
                     cfg.vocab_size)
    res, ref, eng = serve_run("mamba_paged_bf16", PagedServingEngine, cfg,
                              kw, prompts, dev)
    launches = {"mamba_paged_bf16": res["launches"]}
    profile_decode(cfg, eng.params, kw, dev, label="mamba_paged_bf16")
    profile_prefill(cfg, eng.params, kw, dev, label="mamba_paged_bf16")
    with previous_body("selective_scan"):
        profile_decode(cfg, eng.params, kw, dev,
                       label="mamba_paged_bf16, previous scan body")
        profile_prefill(cfg, eng.params, kw, dev,
                        label="mamba_paged_bf16, previous scan body")
    with previous_body("rmsnorm"):
        profile_decode(cfg, eng.params, kw, dev,
                       label="mamba_paged_bf16, previous rmsnorm")
        profile_prefill(cfg, eng.params, kw, dev,
                        label="mamba_paged_bf16, previous rmsnorm")
    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    res, _, eng = serve_run(
        "mamba_dense_bf16", ServingEngine, cfg,
        dict(max_batch=8, cache_len=1024, prefill_chunk=128, decode_steps=16,
             seed=SEED, device=dev), prompts, dev, ref=ref, params=params)
    launches["mamba_dense_bf16"] = res["launches"]
    return launches


@contextlib.contextmanager
def previous_body(kernel: str):
    """Within the block, the model's calls of ``kernel`` take its previous
    (CUDA-core) body, through the wrapper's private ``_body`` argument:
    the profile windows compare the two bodies in one call.  For rmsnorm
    both of the model's wrappers switch: the fused add + norm becomes
    torch's add and then the previous norm."""
    from repro_torch.models import attention, layers, quantize, ssm
    sites = {"paged_decode_attention": [(attention, kernel)],
             "paged_prefill_attention": [(attention, kernel)],
             "ring_chunk_attention": [(attention, kernel)],
             "quant_matmul_int8": [(quantize, kernel)],
             "quant_matmul_int4": [(quantize, kernel)],
             "selective_scan": [(ssm, kernel)],
             "rmsnorm": [(layers, "rmsnorm_kernel"),
                         (layers, "add_rmsnorm_kernel")]}[kernel]
    saved = [(module, name, getattr(module, name)) for module, name in sites]
    for module, name, wrapper in saved:
        setattr(module, name, functools.partial(wrapper, _body="cuda_core"))
    try:
        yield
    finally:
        for module, name, wrapper in saved:
            setattr(module, name, wrapper)


def _port_kernels(kernels) -> list:
    """The port's own kernels of a profile (each in an anonymous
    namespace of ``csrc/``), by device time: the per-kernel split of a
    window's busy time."""
    return [{"name": e.key[:70], "count": e.count,
             "ms": e.self_device_time_total / 1e3}
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)
            if "anonymous namespace" in e.key]


def profile_decode(cfg, params, kw, dev, label: str,
                   prompt_len: int = 256) -> dict:
    """Where decode time goes in two steady macro-steps of 8 rows with
    prompts of ``prompt_len`` tokens (admission, prefill and the first
    macro-step happen before the window).  The window runs twice on identical engines: once timed
    without the profiler (the wall time), once under torch.profiler
    (the device's busy time and the kernels by time).  The idle share is
    one minus busy over the unprofiled wall time."""
    t_call = time.perf_counter()
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import PagedServingEngine, Request
    prompts = _trace(np.random.default_rng(SEED + 3), 8, prompt_len,
                     prompt_len, cfg.vocab_size)

    def warm_engine():
        eng = PagedServingEngine(cfg, params, **kw)
        for i, pr in enumerate(prompts):
            eng.submit(Request(i, pr, max_new_tokens=48))
        eng.step()               # admit + prefill all 8, first macro-step
        torch.cuda.synchronize()
        return eng

    def window(eng):
        t0 = time.perf_counter()
        while eng.active_rows or eng.queue:
            eng.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    eng = warm_engine()
    t_before, pos0 = eng.t, int(eng.pos.min())
    wall = window(eng)
    iters = eng.t - t_before
    eng = warm_engine()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_profiled = window(eng)
    if eng.t - t_before != iters:
        raise AssertionError("the profiled window ran another number of "
                             "decode iterations")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    n_launch = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    res = {"phase": "profile", "run": label,
           "window": f"decode, 8 rows, pos {pos0}-{pos0 + iters - 1}",
           "decode_iters": iters, "wall_ms": wall * 1e3,
           "wall_profiled_ms": wall_profiled * 1e3,
           "ms_per_decode_iter": wall * 1e3 / iters,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
           "device_launches": n_launch,
           "device_launches_per_decode_iter": n_launch / iters,
           "top_kernels": [{"name": e.key[:70], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top],
           "port_kernels": _port_kernels(kernels),
           "seconds": time.perf_counter() - t_call}
    emit(res)
    return res


def profile_verify(cfg, params, kw, dev, label: str) -> dict:
    """Where a verify round's time goes: two steady rounds of 8 rows
    (admission, prefill and the first round happen before the window),
    timed without the profiler, then again under it on an identical
    engine, as ``profile_decode`` does for macro-steps."""
    t_call = time.perf_counter()
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import PagedServingEngine, Request
    prompts = _trace(np.random.default_rng(SEED + 3), 8, 256, 256,
                     cfg.vocab_size)
    rounds = 2

    def warm_engine():
        eng = PagedServingEngine(cfg, params, **kw)
        for i, pr in enumerate(prompts):
            eng.submit(Request(i, pr, max_new_tokens=48))
        eng.step()               # admit + prefill all 8, first round
        torch.cuda.synchronize()
        return eng

    def window(eng):
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    eng = warm_engine()
    wall = window(eng)
    emitted = eng.tokens_generated
    eng = warm_engine()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_profiled = window(eng)
    if eng.spec_rounds != rounds + 1 or eng.active_rows != 8:
        raise AssertionError("the verify window ran another number of "
                             "rounds or lost a row")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    n_launch = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    res = {"phase": "profile", "run": label,
           "window": f"verify, 8 rows, K {eng.spec.k}, {rounds} rounds",
           "verify_rounds": rounds, "wall_ms": wall * 1e3,
           "wall_profiled_ms": wall_profiled * 1e3,
           "ms_per_round": wall * 1e3 / rounds,
           "tokens_emitted_in_3_rounds": emitted,
           "device_busy_ms": busy_us / 1e3,
           "device_busy_ms_per_round": busy_us / 1e3 / rounds,
           "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
           "device_launches": n_launch,
           "device_launches_per_round": n_launch / rounds,
           "top_kernels": [{"name": e.key[:70], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top],
           "port_kernels": _port_kernels(kernels),
           "seconds": time.perf_counter() - t_call}
    emit(res)
    return res


def profile_prefill(cfg, params, kw, dev, label: str,
                    prompt_len: int = 385) -> dict:
    """Where prefill time goes: admission of 8 requests of ``prompt_len``
    tokens (385: 24 chunks of 128 at pos 0, 128 and 256), with no decode.
    As in ``profile_decode``, the window runs once timed without the
    profiler and once under it on an identical engine; the idle share is
    one minus busy over the unprofiled wall time."""
    t_call = time.perf_counter()
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import (PagedServingEngine, Request,
                                            chunk_sizes)
    prompts = _trace(np.random.default_rng(SEED + 6), 8, prompt_len,
                     prompt_len, cfg.vocab_size)
    # a row prefills all of its prompt but the last token
    chunks = sum(len(chunk_sizes(len(p) - 1, kw["prefill_chunk"]))
                 for p in prompts)

    def window():
        eng = PagedServingEngine(cfg, params, **kw)
        for i, pr in enumerate(prompts):
            eng.submit(Request(i, pr, max_new_tokens=8))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._admit()             # the prefill of all 8 rows, no decode
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    window()                     # warm: allocator pools, first launches
    eng, wall = window()
    if eng.prefill_tokens != sum(len(p) - 1 for p in prompts):
        raise AssertionError("the prefill window did not admit every "
                             "request")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall_profiled = window()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    res = {"phase": "profile", "run": label,
           "window": f"prefill, {len(prompts)} requests of "
                     f"{len(prompts[0])} tokens, chunks of "
                     f"{kw['prefill_chunk']}",
           "prefill_chunks": chunks, "wall_ms": wall * 1e3,
           "wall_profiled_ms": wall_profiled * 1e3,
           "ms_per_chunk": wall * 1e3 / chunks,
           "device_busy_ms": busy_us / 1e3,
           "device_busy_ms_per_chunk": busy_us / 1e3 / chunks,
           "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
           "device_launches_per_chunk": sum(e.count for e in kernels) / chunks,
           "top_kernels": [{"name": e.key[:70], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top],
           "port_kernels": _port_kernels(kernels),
           "seconds": time.perf_counter() - t_call}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 6: train
# ---------------------------------------------------------------------------
#: the full train run: smollm-360m at full width and depth in bf16, the
#: reference's train_4k sequence on one card's 8 rows, launch/train.py's
#: learning rate (and so its warmup of max(2, steps // 10) = 2)
TRAIN = {"batch": 8, "seq": 4096, "steps": 8, "lr": 3e-3}
#: the rows every norm of a train step takes (the kernels phase holds
#: rmsnorm there)
TRAIN_ROWS = TRAIN["batch"] * TRAIN["seq"]
#: card-vs-CPU parity in float32: full width, 2 layers
TRAIN_PARITY = {"layers": 2, "batch": 2, "seq": 256, "steps": 3}
#: cuBLAS's kernels, by name, in a profile
CUBLAS_KEYS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


def expected_train_launches(cfg, steps: int) -> tuple:
    """Launches a train run of ``steps`` steps implies: each attn or swa
    layer runs the contiguous flash kernel and its two norms in the
    forward and again in its checkpoint's recompute in the backward pass,
    and the final norm runs once (outside the checkpoints): 2n flash
    launches and 4n + 1 norms a step for n layers.  Every norm but the
    first of the stack takes its residual add (``add_norm``: 2n in the
    forward with the final norm, 2n - 1 in the recompute); every flash
    launch of a bf16 model takes ``mma``.  Returns (launches by kernel,
    launches by body of the two)."""
    from repro_torch.kernels import _build
    n = sum(cfg.block_pattern.count(k) for k in ("attn", "swa"))
    expect = dict.fromkeys(_build.launches, 0)
    expect["flash_attention"] = 2 * n * steps
    expect["rmsnorm"] = (4 * n + 1) * steps
    return expect, {
        "flash_attention": {"mma": 2 * n * steps, "cuda_core": 0},
        "rmsnorm": {"add_norm": (4 * n - 1) * steps, "norm": 2 * steps,
                    "cuda_core": 0}}


@contextlib.contextmanager
def count_plain_calls():
    """Count, within the block, the calls of the plain versions the train
    path's wrappers take for CPU tensors (none may run on the card)."""
    from repro_torch.kernels import flash_attention, rmsnorm
    sites = [(flash_attention, "flash_attention_plain"),
             (rmsnorm, "rmsnorm_plain"), (rmsnorm, "add_rmsnorm_plain")]
    calls = {name: 0 for _, name in sites}
    saved = [(module, name, getattr(module, name)) for module, name in sites]

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper
    for module, name, fn in saved:
        setattr(module, name, counted(name, fn))
    try:
        yield calls
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def train_parity(dev) -> dict:
    """Card against CPU in float32: smollm-360m at full width, 2 layers,
    B 2, S 256, the same CPU-drawn weights on both (TF32 off).  The loss
    and every gradient leaf of one ``value_and_grad``, ``adamw_update``
    fed the same (CPU) gradients on both sides, then three steps of
    ``make_train_step`` on each, whose loss is held at every step.  The
    parameters after several steps are not held element-wise: AdamW's
    first steps move each weight by about lr * sign(g), so a gradient
    near zero that rounds to the other sign moves its weight by 2 lr."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import adamw_init, adamw_update
    from repro_torch.training.train_step import (make_train_step,
                                                 value_and_grad)
    from repro_torch.training.tree import leaves, tree_map
    t_call = time.perf_counter()
    n, b, s = (TRAIN_PARITY[k] for k in ("layers", "batch", "seq"))
    cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=n,
                              block_pattern=("attn",) * n, dtype="float32")
    cpu = Model(cfg, device="cpu")
    card = Model(cfg, device=dev)
    p_cpu = cpu.init(torch.Generator().manual_seed(SEED))
    p_dev = tree_map(lambda a: a.to(dev), p_cpu)
    data = SyntheticLM(cfg.vocab_size, s, b, seed=SEED)
    batches = [torch.from_numpy(data.batch_at(i)["tokens"])
               for i in range(TRAIN_PARITY["steps"])]
    l_cpu, _, g_cpu = value_and_grad(cpu, p_cpu, {"tokens": batches[0]})
    l_dev, _, g_dev = value_and_grad(card, p_dev,
                                     {"tokens": batches[0].to(dev)})
    grad_err = _grad_err([g.cpu() for g in leaves(g_dev)], leaves(g_cpu))
    loss_rel0 = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
    new_cpu = adamw_update(g_cpu, adamw_init(p_cpu), p_cpu, lr=1.5e-3)
    new_dev = adamw_update(tree_map(lambda a: a.to(dev), g_cpu),
                           adamw_init(p_dev), p_dev, lr=1.5e-3)
    upd_err = max((a.cpu().float() - c.float()).abs().max().item()
                  for a, c in zip(leaves(new_dev[:2]), leaves(new_cpu[:2])))
    del g_cpu, g_dev, new_cpu, new_dev
    kw = dict(base_lr=TRAIN["lr"], warmup=2, total_steps=8)
    step_cpu, step_dev = (make_train_step(m, **kw) for m in (cpu, card))
    o_cpu, o_dev = adamw_init(p_cpu), adamw_init(p_dev)
    losses = []
    for tok in batches:
        p_cpu, o_cpu, m_cpu = step_cpu(p_cpu, o_cpu, {"tokens": tok})
        p_dev, o_dev, m_dev = step_dev(p_dev, o_dev, {"tokens": tok.to(dev)})
        losses.append([float(m_cpu["loss"]), float(m_dev["loss"])])
    loss_rel = max(abs(d - c) / abs(c) for c, d in losses)
    res = {"phase": "train", "check": "card vs CPU, float32",
           "config": f"{cfg.name}, {n} layers, float32, B {b}, S {s}",
           "loss_rel_err_first": loss_rel0, "grad_max_rel_err": grad_err,
           "adamw_same_grads_max_abs_err": upd_err,
           "losses_cpu_card": losses, "loss_max_rel_err": loss_rel,
           "tol": {"loss": 1e-5, "grad": 1e-5, "adamw": 1e-6},
           "seconds": time.perf_counter() - t_call}
    emit(res)
    if not (loss_rel0 <= 1e-5 and grad_err <= 1e-5 and upd_err <= 1e-6
            and loss_rel <= 1e-5):
        raise AssertionError(f"train parity: card and CPU disagree: {res}")
    return res


def train_full(dev) -> dict:
    """smollm-360m at full width and depth (32 layers) in bf16, f32 AdamW
    state: ``TRAIN["steps"]`` steps at B 8, S 4096 through
    ``launch/train.py``'s setup (weights from a card Generator seeded 0,
    batches from ``SyntheticLM(seed=0)``), one JSON line a step (ce, grad
    norm, lr, wall ms, tokens/s, peak memory).  Gates: every ce finite,
    the last below the first; the launches exactly as
    ``expected_train_launches`` says, every flash launch on ``mma``; no
    plain version run.  Then one more step under torch.profiler: the
    device's busy ms (and idle share against the steady steps' median
    wall time), the flash kernel's ms, the torch-op backward's
    (``flash_attention_backward``), cuBLAS's and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    from repro_torch.launch.train import device_batch, setup
    t_call = time.perf_counter()
    steps, b, s = TRAIN["steps"], TRAIN["batch"], TRAIN["seq"]
    cfg, model, params, opt, step, data = setup(
        "smollm-360m", smoke=False, steps=steps, batch=b, seq=s,
        lr=TRAIN["lr"], device=dev)
    batches = [device_batch(data, i, dev) for i in range(steps + 1)]
    torch.cuda.synchronize()
    rows = []
    _build.reset_launches()
    with count_plain_calls() as plain_calls:
        for i in range(steps):
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batches[i])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rows.append({"phase": "train", "run": "train_bf16", "step": i,
                         "ce": float(m["ce"]),
                         "grad_norm": float(m["grad_norm"]),
                         "lr": float(m["lr"]), "wall_ms": wall * 1e3,
                         "tok_per_s": b * s / wall,
                         "max_memory_allocated":
                             torch.cuda.max_memory_allocated(dev)})
            emit(rows[-1])
    launches = dict(_build.launches)
    bodies = {k: dict(_build.bodies[k]) for k in ("flash_attention",
                                                  "rmsnorm")}
    expect, expect_bodies = expected_train_launches(cfg, steps)
    ces = [r["ce"] for r in rows]
    walls = sorted(r["wall_ms"] for r in rows[1:])
    wall_ref = walls[len(walls) // 2]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batches[steps])
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda
               and e.key != "flash_attention_backward"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")

    def ms_of(pred):
        return sum(e.self_device_time_total for e in kernels
                   if pred(e.key)) / 1e3
    bwd = [e for e in events if e.key == "flash_attention_backward"]
    res = {"phase": "train", "run": "train_bf16",
           "config": f"{cfg.name}, {cfg.n_layers} layers, {cfg.dtype}, "
                     f"B {b}, S {s}, f32 AdamW state",
           "steps": steps, "ce": ces, "wall_ms_median": wall_ref,
           "tok_per_s_median": b * s / (wall_ref / 1e3),
           "max_memory_allocated": max(r["max_memory_allocated"]
                                       for r in rows),
           "launches": launches, "launches_expected": expect,
           "bodies": bodies, "bodies_expected": expect_bodies,
           "plain_calls": plain_calls,
           "profile": {
               "wall_profiled_ms": wall_profiled * 1e3,
               "device_busy_ms": busy_us / 1e3,
               "device_idle_share": 1 - busy_us / 1e3 / wall_ref,
               "device_launches": sum(e.count for e in kernels),
               "flash_kernel_ms": ms_of(lambda k: "flash_mma_kernel" in k
                                        or "flash_core_kernel" in k),
               "rmsnorm_kernel_ms": ms_of(lambda k: "add_norm_kernel" in k
                                          or "rmsnorm" in k),
               "flash_backward_ms": [e.device_time_total / 1e3
                                     for e in bwd],
               "flash_backward_note": "device time of the kernels launched "
                                      "under the flash_attention_backward "
                                      "label (torch ops), by event kind",
               "cublas_ms": ms_of(lambda k: any(
                   x in k.lower() for x in CUBLAS_KEYS)),
               "top_kernels": [
                   {"name": e.key[:70], "count": e.count,
                    "ms": e.self_device_time_total / 1e3}
                   for e in sorted(kernels,
                                   key=lambda e: -e.self_device_time_total
                                   )[:10]],
               "port_kernels": _port_kernels(kernels)},
           "seconds": time.perf_counter() - t_call}
    emit(res)
    if not (all(np.isfinite(ces)) and ces[-1] < ces[0]):
        raise AssertionError(f"train: ce {ces}: not finite, or not falling")
    if launches != expect or bodies != expect_bodies:
        raise AssertionError(f"train: launches {launches}, bodies {bodies}; "
                             f"expected {expect}, {expect_bodies}")
    if any(plain_calls.values()):
        raise AssertionError(f"train: plain versions ran on the card: "
                             f"{plain_calls}")
    return launches


def train(dev) -> dict:
    """The train phase: ``train_parity``, then ``train_full``.  Returns
    the full run's launch counts, under ``train_bf16``."""
    import gc
    import torch
    train_parity(dev)
    gc.collect()
    torch.cuda.empty_cache()
    return {"train_bf16": train_full(dev)}


def device_tables(dev) -> dict:
    """The card against the constants the split rules read: its SM count
    against ``SM_COUNT`` (decode attention, quant matmul, rmsnorm,
    selective scan) and ``cudaOccupancyMaxActiveClusters`` for clusters
    of 1-8 CTAs at the shared memory of the wide bodies (the paged
    prefill's, the ring form's, which takes the same tiles, and the
    decode's at gemma3-12b's G 2) against ``WIDE_CLUSTERS``.  Raises
    naming each table, size, expected and measured value that differ."""
    import torch
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     quant_matmul, rmsnorm, selective_scan)
    from repro_torch.kernels.launch_floor import max_active_clusters
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bad = [f"{m.__name__}.SM_COUNT: expected {m.SM_COUNT}, got {sms}"
           for m in (decode_attention, quant_matmul, rmsnorm, selective_scan)
           if m.SM_COUNT != sms]
    clusters = {}
    for name, threads, smem in (
            ("paged_prefill_attention", 256,
             flash_attention.prefill_smem_bytes(256)),
            ("ring_chunk_attention", 256,
             flash_attention.prefill_smem_bytes(256)),
            ("paged_decode_attention", 128,
             decode_attention.decode_smem_bytes(256, 2))):
        got = {sp: max_active_clusters(sp, threads, smem)
               for sp in range(1, 9)}
        clusters[name] = {"threads": threads, "smem": smem, "clusters": got}
        bad += [f"WIDE_CLUSTERS[{sp}] at {name}'s {smem} B: expected "
                f"{decode_attention.WIDE_CLUSTERS[sp]}, got {n}"
                for sp, n in got.items()
                if n != decode_attention.WIDE_CLUSTERS[sp]]
    res = {"phase": "device", "check": "SM_COUNT and WIDE_CLUSTERS against "
                                       "this card", "sm_count": sms,
           "max_active_clusters": clusters, "mismatches": bad}
    emit(res)
    if bad:
        raise AssertionError("the split rules' card tables do not match "
                             "this card: " + "; ".join(bad))
    return res


def kernel_line(cases, launches_by_run) -> dict:
    """One entry per kernel, at its main-path shape in its main dtype
    (``MAIN_DTYPE``, else bfloat16: decode rows for the quant matmuls and
    for rmsnorm, on its add_norm body, smollm-360m's hd 64 for the paged
    and dense decode, pos 256 for prefill, the wrapped ring (pos 3000) for
    the ring form, the decode step for the scan), with the launches of the
    serve run that drives it (``LAUNCH_RUN``); every case in ``cases``,
    gemma3-12b's hd 256 rows among them."""
    main = {"rmsnorm": lambda c: (c["shape"] == [8, 960]
                                  and c["body"] == "add_norm"),
            "paged_decode_attention": lambda c: c["shape"]["hd"] == 64,
            "paged_prefill_attention": lambda c: c["shape"]["pos"] == 256,
            "paged_chunk_attention": lambda c: True,
            "ring_chunk_attention": lambda c: c["shape"]["pos"] == 3000,
            "dense_decode_attention": lambda c: c["shape"]["hd"] == 64,
            "quant_matmul_int8": lambda c: c["shape"] == [8, 960, 2560],
            "quant_matmul_int4": lambda c: c["shape"] == [8, 960, 2560],
            "selective_scan": lambda c: c["shape"]["T"] == 1,
            "flash_attention": lambda c: c["shape"]["label"] == "train"}
    out = []
    for name in REPLACES:
        mine = [c for c in cases if c["kernel"] == name]
        c = next(c for c in mine
                 if c["dtype"] == MAIN_DTYPE.get(name, "bfloat16")
                 and main[name](c))
        out.append({"name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name],
                    "launches": launches_by_run[LAUNCH_RUN[name]][name],
                    "launch_run": LAUNCH_RUN[name],
                    "launches_by_run": {run: n[name] for run, n
                                        in launches_by_run.items()},
                    "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                    "prev_ms": c["prev_ms"],
                    "call_ms": c["call_ms"], "plain_ms": c["plain_ms"],
                    "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                    "library_ms": c["library_ms"],
                    **{k: c[k] for k in ("body", "library_pair_ms",
                                         "bytes_bound_ms", "flops_bound_ms")
                       if k in c},
                    "dtype": c["dtype"], "shape": c["shape"],
                    "cases": [{k: x[k] for k in ("dtype", "shape", "body",
                                                 "ms", "prev_ms",
                                                 "call_ms", "plain_ms",
                                                 "library_ms",
                                                 "library_pair_ms",
                                                 "bound_ms", "bound_by",
                                                 "bytes_bound_ms",
                                                 "flops_bound_ms",
                                                 "max_abs_err", "max_rel_err")
                               if k in x}
                              for x in mine]})
    return {"kernels": out}


def main() -> int:
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this test needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.library()
    report = [ln.strip() for ln in _build.ptxas_report().splitlines()
              if "Used" in ln or "Compiling entry" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "key": _build.build_key(),
          "ptxas": report})

    seconds = {}

    def timed(name, fn):
        """Run phase ``name`` and end it with a line of its wall seconds."""
        t = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t
        emit({"phase": name, "seconds": seconds[name]})
        return out

    timed("device", lambda: device_tables(dev))

    cases = timed("kernels", lambda: kernel_cases(dev))
    timed("parity", lambda: parity(dev))
    launches = timed("serve", lambda: serve(dev))
    launches.update(timed("train", lambda: train(dev)))
    emit({"phase": "timing", "seconds": seconds,
          "total": time.perf_counter() - t_start})
    emit(kernel_line(cases, launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
