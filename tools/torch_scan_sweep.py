#!/usr/bin/env python3
"""Time the selective scan's ``state_lanes`` body at every lane count, on
the card.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 tools/torch_scan_sweep.py [--against DIR]

At falcon-mamba-7b's scan shapes (d_inner 8192, d_state 16: decode steps
of 1, 4 and 8 rows, and a one-row prefill chunk of 128 steps) and
zamba2-7b's (d_inner 7168, d_state 64: decode steps of 1 and 8 rows,
and a prefill chunk) it forces each lane count G of 4, 8 and 16 in turn
(through the wrapper's ``scan_lanes`` rule) and prints one JSON line per
shape: the device time
per call in ms for each G (torch.profiler, as ``chip_smoke.py`` measures
kernels), the previous ``cuda_core`` body's time on the same inputs, the
G the rule picks and how much slower that G is than the fastest.  Every
forced G is first held against the plain version (2e-5 of max(1,
|plain|)) and its ``h_T`` against the previous body's, bit for bit.  The
last line counts the instructions the rule's chunk kernel issues per
step and per state update in a full 32-step tile, by opcode, from
``cuobjdump -sass`` of the build (the source of ``chip_smoke.py``'s
issue bound).  The first line is the card's name and power limit.

``--against DIR`` takes another checkout of the repository (an older
commit unpacked with ``git archive``): its ``csrc/selective_scan.cu`` is
built alone into a library of its own, and at falcon-mamba-7b's shapes
its ``state_lanes`` launch (at the G the rule picks) is held against this
tree's on the same inputs, ``y`` and ``h_T`` bit for bit, and both are
timed in turns (this tree, the other, the other, this tree), one JSON
line per shape.  Without a CUDA device it exits with code 2.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: (d_inner, d_state, rows, steps): falcon-mamba-7b, then zamba2-7b
SHAPES = [(8192, 16, 8, 1), (8192, 16, 4, 1), (8192, 16, 1, 1),
          (8192, 16, 1, 128), (7168, 64, 8, 1), (7168, 64, 1, 1),
          (7168, 64, 1, 128)]


def sass_counts(build, g: int, s: int) -> dict:
    """Instructions per step of ``scan_lanes_kernel<G, S>``'s chunk path
    in steady state: the SASS between the first exp (MUFU.EX2) of one
    step and that of the step 31 later, in the densest such window (the
    full tile's unrolled steps, not the partial tile's loop), over the 31
    steps, by opcode."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    obj = build.BUILD_ROOT / build.build_key() / "selective_scan.o"
    if not (os.path.exists(cuobjdump) and obj.exists()):
        return {"sass": "not measured: no cuobjdump or object file"}
    sass = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True,
                          text=True, check=True).stdout
    name = f"scan_lanes_kernelILi{g}ELi{s}ELb0E"
    body = next(f for f in re.split(r"\n\s*Function : ", sass)
                if name in f.split("\n", 1)[0])
    ins = re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*);", body)
    exps = [i for i, x in enumerate(ins) if "MUFU.EX2" in x]
    if len(exps) <= 31 * s:
        return {"sass": f"not measured: scan_lanes_kernel<{g}, {s}>'s chunk "
                        f"path holds no 31 unrolled steps"}
    first = min(range(len(exps) - 31 * s),
                key=lambda i: exps[i + 31 * s] - exps[i])
    span = ins[exps[first]:exps[first + 31 * s]]
    ops = collections.Counter(x.split()[1] if x.startswith("@") else
                              x.split()[0] for x in span)
    return {"sass": f"scan_lanes_kernel<{g}, {s}>, chunk path",
            "instr_per_step": len(span) / 31,
            "instr_per_update": len(span) / 31 / s,
            "per_update_by_opcode": {k: v / 31 / s
                                     for k, v in ops.most_common()}}


def other_library(build, root: str):
    """``rt_selective_scan`` of the checkout at ``root``: its
    ``selective_scan.cu`` compiled alone (with that checkout's headers)
    into a library under this tree's build directory."""
    csrc = os.path.join(root, "src", "repro_torch", "csrc")
    out = build.BUILD_ROOT / "against"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libscan.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-shared",
                    "-o", str(lib), os.path.join(csrc, "selective_scan.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).rt_selective_scan
    argtypes = list(build._SIGNATURES["rt_selective_scan"])
    with open(os.path.join(csrc, "selective_scan.cu")) as f:
        takes_ck = "void* h_out, void* ck," in f.read()
    if not takes_ck:            # a checkout from before the checkpoints
        del argtypes[8]
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn, takes_ck


def against(root: str, f32) -> None:
    """This tree's scan launch at falcon-mamba-7b's shapes against the
    checkout at ``root``'s: the same bits, timed in turns."""
    import torch
    from chip_smoke import device_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ss
    other, takes_ck = other_library(_build, root)
    for di, ds, b, t in SHAPES:
        if ds != 16:
            continue
        dt = torch.nn.functional.softplus(f32((b, t, di)))
        x, h0 = f32((b, t, di)), f32((b, di, ds))
        bm, cm = f32((b, t, ds)), f32((b, t, ds))
        a_neg = -f32((di, ds)).abs()
        g = ss.scan_lanes(b, di, ds)

        def old(h):
            y = torch.empty_like(dt)
            _build.check(other(
                dt.data_ptr(), bm.data_ptr(), cm.data_ptr(), x.data_ptr(),
                a_neg.data_ptr(), h.data_ptr(), y.data_ptr(), h.data_ptr(),
                *((None,) if takes_ck else ()),
                b, t, di, ds, bm.stride(0), bm.stride(1),
                _build.BODY_CODES["state_lanes"], g,
                torch.cuda.current_stream().cuda_stream), "other scan")
            return y, h

        h_new, h_old = h0.clone(), h0.clone()
        y_new, _ = ss.selective_scan(dt, bm, cm, x, a_neg, h_new, h_out=h_new)
        y_old, _ = old(h_old)
        equal = torch.equal(y_new, y_old) and torch.equal(h_new, h_old)
        hs = h0.clone()
        turns = [device_ms(f) for f in (
            lambda: ss.selective_scan(dt, bm, cm, x, a_neg, hs, h_out=hs),
            lambda: old(hs), lambda: old(hs),
            lambda: ss.selective_scan(dt, bm, cm, x, a_neg, hs, h_out=hs))]
        print(json.dumps({"against": root, "B": b, "T": t, "DI": di,
                          "DS": ds, "lanes": g, "y_and_h_equal": equal,
                          "ms": (turns[0] + turns[3]) / 2,
                          "other_ms": (turns[1] + turns[2]) / 2,
                          "turns_ms": turns}), flush=True)
        if not equal:
            raise AssertionError(f"B {b}, T {t}: this tree's scan gives other "
                                 f"bits than {root}'s")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", help="another checkout whose scan launch "
                    "this tree's is held to and timed against")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_scan_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from chip_smoke import device_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ss

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    _build.library()
    rng = np.random.default_rng(0)

    def f32(shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    if opts.against:
        against(opts.against, f32)
    rule = ss.scan_lanes
    for di, ds, b, t in SHAPES:
        dt = torch.nn.functional.softplus(f32((b, t, di)))
        x, h0 = f32((b, t, di)), f32((b, di, ds))
        bm, cm = f32((b, t, ds)), f32((b, t, ds))
        a_neg = -f32((di, ds)).abs()
        args = (dt, bm, cm, x, a_neg, h0)
        want_y, want_h = ss.selective_scan_plain(*args)
        _, prev_h = ss.selective_scan(*args, _body="cuda_core")
        hs = h0.clone()                  # the timed calls update it in place
        row = {"B": b, "T": t, "DI": di, "DS": ds, "rule": rule(b, di, ds),
               "ms": {}, "max_rel_err": {},
               "prev_ms": device_ms(lambda: ss.selective_scan(
                   dt, bm, cm, x, a_neg, hs, h_out=hs, _body="cuda_core"))}
        for g in ss.SCAN_LANES:
            ss.scan_lanes = lambda *a, g=g: g
            y, h = ss.selective_scan(*args)
            err = max(((y - want_y).abs() / want_y.abs().clamp(min=1)).max()
                      .item(), ((h - want_h).abs()
                                / want_h.abs().clamp(min=1)).max().item())
            if not (err <= 2e-5 and torch.equal(h, prev_h)):
                raise AssertionError(f"G {g} at B {b}, T {t}: error {err} "
                                     f"against the plain version, h_T equal "
                                     f"to the previous body's: "
                                     f"{torch.equal(h, prev_h)}")
            row["max_rel_err"][g] = err
            row["ms"][g] = device_ms(lambda: ss.selective_scan(
                dt, bm, cm, x, a_neg, hs, h_out=hs))
        ss.scan_lanes = rule
        best = min(row["ms"], key=row["ms"].get)
        row["fastest"] = best
        row["rule_over_fastest"] = row["ms"][row["rule"]] / row["ms"][best] - 1
        print(json.dumps(row), flush=True)
    for di, ds in sorted({(di, ds) for di, ds, _, _ in SHAPES},
                         reverse=True):
        g = rule(1, di, ds)
        print(json.dumps(sass_counts(_build, g, -(-ds // g))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
