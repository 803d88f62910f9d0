"""Training entry point (the port's counterpart of ``repro/launch/train.py``).

Smoke scale, on the CPU::

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --smoke --steps 100 --batch 8 --seq 64 --device cpu

Full scale, on one card (the default ``--device cuda``)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 8 --batch 8 --seq 4096

The reference's flags, and ``--device``; no mesh and no ``--multi-pod``
(one device).  The weights are drawn from a ``torch.Generator`` seeded
0 (other draws than ``jax.random``'s: bridge the reference's weights to
run them), the batches come from ``SyntheticLM(seed=0)`` with the
reference's frontend (zeros of (batch, n_image_tokens, d_model) for a
vision config, of (batch, encoder_seq, d_model) for an
encoder-decoder), and the step line is the reference's: ce, gradient
norm, tokens/s.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.bridge import params_to_numpy
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.training import checkpoint
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_step import make_train_step
from repro_torch.training.tree import leaves


def setup(arch: str, *, smoke: bool, steps: int, batch: int, seq: int,
          lr: float, device="cuda", overrides: Optional[dict] = None):
    """(cfg, model, params, opt_state, train_step, data) as :func:`main`
    builds them: the schedule warms up over ``max(2, steps // 10)`` steps
    and decays to the last.  ``overrides`` replaces config fields (a cut
    of depth or vocab: ``n_layers`` with its ``block_pattern``)."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(model, base_lr=lr, warmup=max(2, steps // 10),
                           total_steps=steps)
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    return cfg, model, params, adamw_init(params), step, data


def device_batch(data: SyntheticLM, i: int, device, cfg=None) -> dict:
    """Batch ``i`` on ``device``; with ``cfg``, and a cross or encoder
    source in it, the reference trainer's frontend: zeros of (batch,
    n_image_tokens, d_model) or (batch, encoder_seq, d_model)."""
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(i).items()}
    src = cfg and (cfg.encoder_seq if cfg.is_encoder_decoder
                   else cfg.n_image_tokens)
    if src:
        batch["frontend"] = torch.zeros((data.batch, src, cfg.d_model),
                                        device=device)
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's kernels) or cpu (the plain "
                         "versions)")
    args = ap.parse_args(argv)

    cfg, model, params, opt, step, data = setup(
        args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, device=args.device)
    n = sum(p.numel() for p in leaves(params))
    print(f"[train] {cfg.name}: {n/1e6:.1f}M params, "
          f"device={model.device}", flush=True)
    t0 = time.time()
    for i in range(args.steps):
        params, opt, metrics = step(params, opt,
                                    device_batch(data, i, model.device, cfg))
        if i % args.log_every == 0 or i == args.steps - 1:
            toks = args.batch * args.seq * (i + 1)
            print(f"step {i:4d}  ce={float(metrics['ce']):.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.2f}  "
                  f"tok/s={toks/(time.time()-t0):,.0f}", flush=True)
    if args.ckpt:
        checkpoint.save(args.ckpt, params_to_numpy(params, cfg))
        print(f"[train] checkpoint -> {args.ckpt}")
    return params


if __name__ == "__main__":
    main()
