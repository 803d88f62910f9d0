#!/usr/bin/env python3
"""Time rmsnorm's ``add_norm`` and ``norm`` bodies at every launch shape
the kernel takes, on the card.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 tools/torch_norm_sweep.py

At the main path's norm shapes (8 decode rows and 128 prefill rows of
smollm-360m's 960 and falcon-mamba-7b's 4096, in bf16, and in float32 as
the parity runs take them) it forces, through the wrapper's
``norm_lanes`` rule, each launch shape the kernel takes: 1, 2, 4 or 8
warps a row, with the fewest accesses a lane that hold the row, and for
one-warp rows 1, 2, 4 or 8 rows a block.  Each is first held against
the plain version (``r`` bit-equal to torch's ``x + delta``, ``out``
within ``chip_smoke.py``'s gate).  It prints one JSON line per shape:
the device time per call in ms of each launch shape for both bodies
(torch.profiler, as ``chip_smoke.py`` measures kernels), the previous
``cuda_core`` norm and the previous composition (torch's add, then
``cuda_core``) on the same inputs, the shape the rule picks and how much
slower than the fastest it is.  The first line is the card's name and
power limit.  Without a CUDA device it exits with code 2.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SHAPES = [(8, 960), (128, 960), (8, 4096), (128, 4096)]   # (rows, d)


def launch_shapes(nm, rows: int, d: int, pack: int) -> list:
    """Every (lanes, rows a block, accesses a lane) the kernel takes for
    these rows."""
    n_acc = -(-d // pack)
    out = []
    warps = 1
    while warps <= nm.NORM_MAX_WARPS:
        per = -(-n_acc // (32 * warps))
        vecs = next((v for v in nm.NORM_VECS if v >= per), None)
        for rpb in ((1, 2, 4, 8) if warps == 1 else (1,)):
            if vecs is not None and rpb <= rows:
                out.append((32 * warps, rpb, vecs))
        warps *= 2
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_norm_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from chip_smoke import TOL, _errors, device_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as nm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    _build.library()
    rng = np.random.default_rng(0)
    rule = nm.norm_lanes
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        for rows, d in SHAPES:
            def card(shape):
                return torch.from_numpy(rng.standard_normal(
                    shape, dtype=np.float32)).to(dev, dtype)
            x, dl, sc = card((rows, d)), card((rows, d)), card((d,))
            want = nm.add_rmsnorm_plain(x, dl, sc)[1]
            pack = nm.norm_pack(dtype, d)
            row = {"dtype": dname, "rows": rows, "d": d,
                   "rule": list(rule(rows, d, pack)),
                   "add_norm_ms": {}, "norm_ms": {},
                   "prev_ms": device_ms(lambda: nm.add_rmsnorm(
                       x, dl, sc, _body="cuda_core")),
                   "cuda_core_ms": device_ms(lambda: nm.rmsnorm(
                       x, sc, _body="cuda_core"))}
            for shape in launch_shapes(nm, rows, d, pack):
                nm.norm_lanes = lambda *a, shape=shape: shape
                r, out = nm.add_rmsnorm(x, dl, sc)
                ok = _errors(out, want, dname, TOL, False)[3]
                if not (torch.equal(r, x + dl) and ok):
                    raise AssertionError(f"{dname} {rows}x{d} at {shape}: "
                                         f"r equal {torch.equal(r, x + dl)}"
                                         f", out within the gate {ok}")
                key = "x".join(map(str, shape))
                row["add_norm_ms"][key] = device_ms(
                    lambda: nm.add_rmsnorm(x, dl, sc))
                row["norm_ms"][key] = device_ms(lambda: nm.rmsnorm(x, sc))
            nm.norm_lanes = rule
            times = row["add_norm_ms"]
            best = min(times, key=times.get)
            rule_key = "x".join(map(str, row["rule"]))
            row["fastest_add_norm"] = best
            row["rule_over_fastest"] = times[rule_key] / times[best] - 1
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
