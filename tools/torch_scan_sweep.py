#!/usr/bin/env python3
"""Time the selective scan's ``state_lanes`` body at every lane count, on
the card.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 tools/torch_scan_sweep.py

At falcon-mamba-7b's scan shapes (d_inner 8192, d_state 16: decode steps
of 1, 4 and 8 rows, and a one-row prefill chunk of 128 steps) it forces
each lane count G of 4, 8 and 16 in turn (through the wrapper's
``scan_lanes`` rule) and prints one JSON line per shape: the device time
per call in ms for each G (torch.profiler, as ``chip_smoke.py`` measures
kernels), the previous ``cuda_core`` body's time on the same inputs, the
G the rule picks and how much slower that G is than the fastest.  Every
forced G is first held against the plain version (2e-5 of max(1,
|plain|)) and its ``h_T`` against the previous body's, bit for bit.  The
last line counts the instructions the rule's chunk kernel issues per
step and per state update in a full 32-step tile, by opcode, from
``cuobjdump -sass`` of the build (the source of ``chip_smoke.py``'s
issue bound).  The first line is the card's name and power limit.
Without a CUDA device it exits with code 2.
"""
from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

DI, DS = 8192, 16                        # falcon-mamba-7b
SHAPES = [(8, 1), (4, 1), (1, 1), (1, 128)]   # (rows, steps)


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


def main() -> int:
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

    rule = ss.scan_lanes
    for b, t in SHAPES:
        dt = torch.nn.functional.softplus(f32((b, t, DI)))
        x, h0 = f32((b, t, DI)), f32((b, DI, DS))
        bm, cm = f32((b, t, DS)), f32((b, t, DS))
        a_neg = -f32((DI, DS)).abs()
        args = (dt, bm, cm, x, a_neg, h0)
        want_y, want_h = ss.selective_scan_plain(*args)
        _, prev_h = ss.selective_scan(*args, _body="cuda_core")
        hs = h0.clone()                  # the timed calls update it in place
        row = {"B": b, "T": t, "DI": DI, "DS": DS, "rule": rule(b, DI, DS),
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
    g = rule(1, DI, DS)
    print(json.dumps(sass_counts(_build, g, -(-DS // g))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
