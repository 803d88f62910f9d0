#!/usr/bin/env python3
"""Time the contiguous flash form's ``wgmma`` body beside the ``mma``
body and SDPA, on the card.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 tools/torch_flash_sweep.py

At smollm-360m's train shape (B 8, S 4096, 15 / 5 heads of 64, causal,
bf16), at the non-causal encoder case (B 2, S 1000, 6 / 2 heads), at
llama-3.2-vision-90b's ``Model.prefill`` (B 8, S 128, 64 / 8 heads of
128, causal) and at a long hd-128 row (B 1, S 4096, 32 / 8 heads) it
times, in turns (the list, then the list reversed, each time averaged
over both), the ``wgmma`` body (the rule's), the ``mma`` body
(``_body="mma"``) and ``F.scaled_dot_product_attention``.  Each body's
output is first held against the plain version under
chip_smoke.py's bf16 gate (2e-2, two bf16 rounding steps), and its row
log-sum-exp within 1e-2.  One JSON line per shape: device ms per call
(torch.profiler, as ``chip_smoke.py`` measures kernels) by body,
TFLOP/s at 4 hd flops a (query head, key) pair, the errors, and the SM
clock and power draw ``nvidia-smi`` read every 100 ms while the turns
ran (median and range).  The first line is the card's name and power
limit, then the ptxas report of the ``wgmma`` body, its CTAs an SM,
shared memory and keys a K/V tile (``wgmma_occupancy``) and the
instruction mix of its hot loop (``cuobjdump -sass``).  Without a CUDA
device it exits with code 2.
"""
from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: (label, B, S, H, KV, hd, causal)
SHAPES = [("train", 8, 4096, 15, 5, 64, True),
          ("encoder", 2, 1000, 6, 2, 64, False),
          ("vision_prefill", 8, 128, 64, 8, 128, True),
          ("hd128_long", 1, 4096, 32, 8, 128, True)]


def sass_counts(build) -> dict:
    """The instruction mix of the ``wgmma`` body's hot loop (``cuobjdump
    -sass`` of the build): the innermost loop of ``flash_wgmma_kernel``
    at hd 64
    (a backward branch and its target)
    that issues a tile's S beside the previous tile's P V (20 HGMMA); it
    holds both softmax paths, masked and not.  Its instructions by
    opcode."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    obj = build.BUILD_ROOT / build.build_key() / "flash_attention.o"
    if not (os.path.exists(cuobjdump) and obj.exists()):
        return {"sass": "not measured: no cuobjdump or object file"}
    sass = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True,
                          text=True, check=True).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", sass)
                if "flash_wgmma_kernelILi64E" in f.split("\n", 1)[0])
    ins = [(int(a, 16), x) for a, x in
           re.findall(r"/\*([0-9a-f]{4,5})\*/\s+([^;]*);", body)]
    where = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (a, x) in enumerate(ins):
        m = re.search(r"BRA.*0x([0-9a-f]+)", x)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in where:
            loops.append((where[int(m.group(1), 16)], i))
    # the innermost loop that issues a whole tile's products: S's 4
    # m64n128k16 and P V's 16 m64n64k16
    lo, hi = min(((i, j) for i, j in loops
                  if sum("HGMMA" in x for _, x in ins[i:j + 1]) >= 20),
                 key=lambda ij: ij[1] - ij[0])
    ops = collections.Counter(
        (x.split()[1] if x.startswith("@") else x.split()[0]).split(".")[0]
        for _, x in ins[lo:hi + 1])
    return {"sass": "flash_wgmma_kernel<64>, hot loop",
            "instructions": hi - lo + 1, "by_opcode": dict(ops.most_common())}


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_flash_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from chip_smoke import (BF16_ATOL, BF16_RTOL, device_ms, flash_pairs)
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.library()
    report = _build.ptxas_report().splitlines()
    for i, ln in enumerate(report):
        if "Compiling entry" in ln and "flash_wgmma" in ln:
            print(json.dumps({"ptxas": [x.strip() for x in report[i:i + 4]
                                        if "spill" in x or "Used" in x
                                        or "Compiling" in x]}), flush=True)
    print(json.dumps({"occupancy": {hd: fa.wgmma_occupancy(hd)
                                    for hd in fa.WGMMA_HD}}), flush=True)
    print(json.dumps(sass_counts(_build)), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, b, s, h, kv, hd, causal in SHAPES:
        q = torch.randn(b, h, s, hd, device=dev, generator=gen,
                        dtype=torch.bfloat16)
        k = torch.randn(b, kv, s, hd, device=dev, generator=gen,
                        dtype=torch.bfloat16)
        v = torch.randn(b, kv, s, hd, device=dev, generator=gen,
                        dtype=torch.bfloat16)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal)
        runs = {
            "wgmma": lambda: fa.flash_attention(q, k, v, causal=causal),
            "mma": lambda: fa.flash_attention(q, k, v, causal=causal,
                                              _body="mma"),
            "sdpa": lambda: (F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), None)}
        errors = {}
        for name, fn in runs.items():
            out, lse = fn()
            if lse is None:
                continue
            diff = (out.float() - ref.float()).abs()
            excess = (diff - BF16_RTOL * ref.float().abs()).max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            errors[name] = {"max_abs_err": diff.max().item(),
                            "bf16_step_excess": excess, "lse_err": lse_err,
                            "ok": diff.max().item() <= 2e-2
                            and excess <= BF16_ATOL and lse_err <= 1e-2}
        order = list(runs) + list(reversed(runs))
        turns = {name: [] for name in runs}
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        try:
            for name in order:
                turns[name].append(device_ms(runs[name]))
        finally:
            smi.terminate()
            samples = [ln.split(",") for ln in smi.communicate()[0].split(
                "\n") if ln.count(",") == 1]
        clocks = sorted(float(c) for c, _ in samples)
        watts = sorted(float(w) for _, w in samples)
        ms = {name: sum(t) / len(t) for name, t in turns.items()}
        flops = 4 * hd * b * h * flash_pairs(s, causal, 0)
        print(json.dumps({
            "shape": {"label": label, "B": b, "S": s, "H": h, "KV": kv,
                      "hd": hd, "causal": causal},
            "ms": ms, "turns_ms": turns,
            "tflops": {n: flops / (t * 1e-3) / 1e12 for n, t in ms.items()},
            "mma_over_wgmma": ms["mma"] / ms["wgmma"],
            "wgmma_over_sdpa": ms["wgmma"] / ms["sdpa"],
            "sm_clock_mhz": {"median": clocks[len(clocks) // 2],
                             "min": clocks[0], "max": clocks[-1]}
            if clocks else None,
            "power_w": {"median": watts[len(watts) // 2], "min": watts[0],
                        "max": watts[-1]} if watts else None,
            "errors": errors}), flush=True)
        if not all(e["ok"] for e in errors.values()):
            print(f"torch_flash_sweep: a body disagrees with the plain "
                  f"version at {label}", file=sys.stderr)
            return 1
        del q, k, v, ref, ref_lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
