"""Decode throughput of the port's paged engine, for two checkouts of the
port on one card, in turns.

  python tools/torch_serve_ab.py --src OTHER/src --src src \\
      --order ABBA --out serve_ab.json

Each turn of ``--order`` (A the first ``--src``, B the second) is a
process of its own that imports the port from that ``src`` directory.
It builds smollm-360m at its published size (32 layers, bf16, weights
drawn from seed 0) in a ``PagedServingEngine`` of 8 rows (max_len 1024,
chunks of 128, macro-steps of 16 decode iterations), then ``REPS`` + 1
times (the first warms up): submits 8 requests of 257-token prompts,
runs one engine step (admission, prefill, the first macro-step) and
times the remaining ``STEPS`` macro-steps (the host's clock around the
steps, synchronised with the card).  A turn prints one JSON line with
each window's decode tokens a second and their median; the last line
holds every turn's median, by checkout, and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

#: timed windows a turn, and macro-steps a window
REPS, STEPS = 5, 4
#: decode iterations a macro-step
K = 16


def worker(src: str) -> dict:
    sys.path.insert(0, os.path.abspath(src))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import PagedServingEngine, Request
    _build.library()
    cfg = get_config("smollm-360m")
    eng = PagedServingEngine(cfg, max_rows=8, max_len=1024, block_size=16,
                             prefill_chunk=128, decode_steps=K, seed=0,
                             device="cuda")
    rng = np.random.default_rng(3)
    tok_s = []
    for rep in range(REPS + 1):
        reqs = [Request(rep * 8 + i,
                        rng.integers(1, cfg.vocab_size, 257).tolist(),
                        max_new_tokens=1 + K * (STEPS + 1))
                for i in range(8)]
        for r in reqs:
            eng.submit(r)
        eng.step()
        torch.cuda.synchronize()
        n0 = sum(len(r.out_tokens) for r in reqs)
        t0 = time.perf_counter()
        while eng.active_rows or eng.queue:
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rep:
            tok_s.append((sum(len(r.out_tokens) for r in reqs) - n0) / wall)
    return {"src": src, "arch": cfg.name, "n_layers": cfg.n_layers,
            "dtype": cfg.dtype, "rows": 8, "decode_steps": K,
            "decode_tok_s": tok_s, "median": statistics.median(tok_s)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    turns = []
    for c in args.order:
        src = args.src["AB".index(c)]
        out = subprocess.run([sys.executable, __file__, "--worker", src],
                             capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[-1]
        print(out, flush=True)
        turns.append(json.loads(out))
    summary = {"order": args.order, "medians": {
        src: [t["median"] for t in turns if t["src"] == src]
        for src in args.src},
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"turns": turns, **summary}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
