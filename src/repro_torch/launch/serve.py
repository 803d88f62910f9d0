"""Serving entry point: the slot engine and a stream of requests (the port's
counterpart of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --smoke --requests 16 --max-new 12

The reference's flags, and ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions).  Requests are drawn from
``np.random.default_rng(0)`` as the reference draws them; the weights
from a ``torch.Generator`` seeded 0 (not ``jax.random``'s draws), so the
tokens differ from the reference's while the summary line has its form.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder_decoder or cfg.n_image_tokens:
        print(f"[serve] note: {args.arch} needs frontend embeddings; "
              "serving text-only decoder path")
    eng = ServingEngine(cfg, max_batch=args.max_batch,
                        cache_len=args.cache_len, device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size,
                              size=rng.integers(2, 8)).tolist()
        eng.submit(Request(id=i, prompt=prompt, max_new_tokens=args.max_new))
    done = eng.run()
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {cfg.name}: {len(done)}/{args.requests} requests, "
          f"{toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s)")
    for r in done[:3]:
        print(f"  req {r.id}: {r.out_tokens}")
    return done


if __name__ == "__main__":
    main()
