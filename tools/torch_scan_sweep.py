#!/usr/bin/env python3
"""Time the selective scan's ``state_lanes`` body at every lane count, on
the card.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 tools/torch_scan_sweep.py [--backward] [--against DIR]

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
line per shape.

``--backward`` times the scan's backward kernel instead, at
``chip_smoke.py``'s ``SCAN_BWD_CASES`` (falcon-mamba-7b's and zamba2-7b's
train shapes, inputs in the model's range), one JSON line per shape:
this tree's launch held against ``selective_scan_backward_plain`` (2e-5
of max(1, |plain|), two launches bit-equal), its blocks an SM and its
bound, and beside it, each timed in turns with this tree's (this tree,
the other, the other, this tree) on the same inputs: with ``--against``
the other checkout's backward (built alone as above, its grid and
partials' type read from its source), and four variants of this tree's
kernel, each built from this source with one macro of
``csrc/selective_scan.cu`` set, so each moves one cost: the partials in
float (half their bytes), one block an SM (shared memory padded), the
gradient algebra in float (timed only: its sums lose the bits the gate
needs), and registers capped for three blocks an SM.
Without a CUDA device it exits with code 2.
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


#: variants of this tree's backward kernel (``--backward``): the macros
#: of csrc/selective_scan.cu each sets, and the cost it moves
BWD_VARIANTS = {"float_partials": ("-DRT_BWD_PART=float",),
                "one_block_an_sm": ("-DRT_BWD_SMEM_PAD=120832",),
                "float_algebra": ("-DRT_BWD_REAL=float",),
                "three_blocks_an_sm": ("-DRT_BWD_MIN_BLOCKS=3",)}


def scan_libraries(build, sources: dict) -> dict:
    """``selective_scan.cu`` of each ``name -> (checkout root, nvcc
    defines)`` compiled alone (with that checkout's headers) into a
    library of its own under this tree's build directory, all at once;
    name -> the loaded library."""
    procs = {}
    for name, (root, defines) in sources.items():
        csrc = os.path.join(root, "src", "repro_torch", "csrc")
        out = build.BUILD_ROOT / "against" / name
        out.mkdir(parents=True, exist_ok=True)
        procs[name] = (out / "libscan.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *defines, "-I", csrc,
             "-shared", "-o", str(out / "libscan.so"),
             os.path.join(csrc, "selective_scan.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}'s selective_scan.cu:"
                               f"\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def other_library(build, root: str):
    """``rt_selective_scan`` of the checkout at ``root``, built by
    :func:`scan_libraries`, and whether it takes checkpoints."""
    csrc = os.path.join(root, "src", "repro_torch", "csrc")
    fn = scan_libraries(build, {"other": (root, ())})[
        "other"].rt_selective_scan
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


def bwd_layout(root: str) -> dict:
    """The backward grid and partials of the checkout at ``root``, read
    from its ``selective_scan.cu``: threads a block, and the partials'
    dtype (``RT_BWD_PART``; double where the source names none)."""
    import torch
    with open(os.path.join(root, "src", "repro_torch", "csrc",
                           "selective_scan.cu")) as f:
        src = f.read()
    part = re.search(r"#define RT_BWD_PART (\w+)", src)
    return {"threads": int(re.search(r"kBwdThreads = (\d+);", src).group(1)),
            "part": getattr(torch, part.group(1) if part else "double")}


def bwd_launch(lib, layout: dict, args) -> tuple:
    """(d_dt, dB, dC, dx, dA, dh0) of ``rt_selective_scan_backward`` in
    ``lib`` on ``args`` (dt, B, C, x, A, checkpoints, dy; dh_T zero), at
    the grid and partials ``layout`` names."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ss
    dt, bm, cm, x, a_neg, ck, dy = args
    b, t, di = dt.shape
    ds = a_neg.shape[-1]
    g = ss.bwd_lanes(ds)
    nblk = -(-di // (layout["threads"] // g))
    f32 = dict(dtype=torch.float32, device=dt.device)
    outs = (torch.empty_like(dt), torch.empty((b, t, ds), **f32),
            torch.empty((b, t, ds), **f32), torch.empty_like(dt),
            torch.empty((di, ds), **f32), torch.empty((b, di, ds), **f32))
    d_dt, db, dc, dx, da, dh0 = outs
    part_b = torch.empty((b, nblk, t, ds), dtype=layout["part"],
                         device=dt.device)
    part_c = torch.empty_like(part_b)
    part_a = torch.empty((b, di, ds), dtype=torch.float64, device=dt.device)
    fn = lib.rt_selective_scan_backward
    fn.argtypes = list(_build._SIGNATURES["rt_selective_scan_backward"])
    fn.restype = ctypes.c_int
    _build.check(fn(
        dt.data_ptr(), bm.data_ptr(), cm.data_ptr(), x.data_ptr(),
        a_neg.data_ptr(), ck.data_ptr(), dy.data_ptr(), None,
        d_dt.data_ptr(), db.data_ptr(), dc.data_ptr(), dx.data_ptr(),
        da.data_ptr(), dh0.data_ptr(), part_b.data_ptr(), part_c.data_ptr(),
        part_a.data_ptr(), b, t, di, ds, bm.stride(0), bm.stride(1), g, nblk,
        torch.cuda.current_stream().cuda_stream), "other scan backward")
    return outs


def bwd_blocks_per_sm(lib, ds: int) -> int:
    """Blocks an SM of ``lib``'s backward kernel at d_state ``ds``, from
    its occupancy entry (``None`` where the library has none)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ss
    fn = getattr(lib, "rt_selective_scan_backward_occupancy", None)
    if fn is None:
        return None
    fn.argtypes = list(_build._SIGNATURES[
        "rt_selective_scan_backward_occupancy"])
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(fn(ss.bwd_lanes(ds), ctypes.byref(blocks),
                    ctypes.byref(smem)), "backward occupancy")
    return blocks.value


def backward(root) -> None:
    """The backward kernel at ``SCAN_BWD_CASES``: this tree's against the
    plain version, and timed in turns against the checkout at ``root``'s
    (when given) and against each of ``BWD_VARIANTS``."""
    import torch
    from chip_smoke import (HBM_BYTES_PER_S, PEAK_FLOPS, SCAN_BWD_CASES,
                            SCAN_BWD_OPS, SEED, bound, device_ms,
                            scan_train_inputs)
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as ss
    sources = {name: (ROOT, defines) for name, defines in BWD_VARIANTS.items()}
    if root:
        sources["against"] = (root, ())
    libs = scan_libraries(_build, sources)
    layouts = {name: bwd_layout(ROOT) for name in BWD_VARIANTS}
    layouts["float_partials"] = {**layouts["float_partials"],
                                 "part": torch.float32}
    if root:
        layouts["against"] = bwd_layout(root)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 30)
    for model, b, t, di, ds, mamba2 in SCAN_BWD_CASES:
        dt, bm, cm, x, a_neg, dy = scan_train_inputs(dev, rng, b, t, di, ds,
                                                     mamba2)
        nc = ss.scan_checkpoints(t)
        ck = torch.empty((b, nc, di, ds), device=dev)
        ss.selective_scan(dt, bm, cm, x, a_neg, torch.zeros(
            (b, di, ds), device=dev), checkpoints=ck)
        args = (dt, bm, cm, x, a_neg, ck, dy)
        want = ss.selective_scan_backward_plain(*args)

        def err(got):
            return max(((g - w).abs() / w.abs().clamp(min=1)).max().item()
                       for g, w in zip(got, want))

        def mine():
            return ss.selective_scan_backward(*args)
        got, again = mine(), mine()
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        nbytes = 4 * (5 * b * t * di + 4 * b * t * ds + 2 * di * ds
                      + b * nc * di * ds + b * di * ds)
        t_bound, by = bound(nbytes, b * t * di * (3 + SCAN_BWD_OPS * ds),
                            "float32")
        row = {"backward": model, "B": b, "T": t, "DI": di, "DS": ds,
               "mamba2": mamba2, "lanes": ss.bwd_lanes(ds),
               "blocks": b * ss.bwd_blocks(di, ds),
               "blocks_per_sm": ss.bwd_occupancy(ds)[0],
               "max_rel_err": err(got), "same_bits": same,
               "bound_ms": t_bound, "bound_by": by,
               "hbm_bytes_per_s": HBM_BYTES_PER_S,
               "peak_f32_per_s": PEAK_FLOPS["float32"], "others": {}}
        for name, lib in libs.items():
            def other(lib=lib, name=name):
                return bwd_launch(lib, layouts[name], args)
            o1, o2 = other(), other()
            turns = [device_ms(f, n=10, warmup=2)
                     for f in (mine, other, other, mine)]
            row["others"][name] = {
                "ms": (turns[1] + turns[2]) / 2,
                "this_ms": (turns[0] + turns[3]) / 2, "turns_ms": turns,
                "max_rel_err": err(o1),
                "same_bits": all(torch.equal(g, a) for g, a in zip(o1, o2)),
                "threads": layouts[name]["threads"],
                "partials": str(layouts[name]["part"]).split(".")[-1],
                "blocks_per_sm": bwd_blocks_per_sm(lib, ds)}
            del o1, o2
        print(json.dumps(row), flush=True)
        if not (row["max_rel_err"] <= 2e-5 and same):
            raise AssertionError(f"{model}: the backward kernel is off the "
                                 f"plain version by {row['max_rel_err']} "
                                 f"(two launches equal: {same})")
        del args, want, got, again, ck
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", help="another checkout whose scan launch "
                    "this tree's is held to and timed against")
    ap.add_argument("--backward", action="store_true",
                    help="time the backward kernel (against --against's "
                    "and this source's variants) instead of the forward")
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

    if opts.backward:
        backward(opts.against)
        return 0
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
