"""Quickstart of the PyTorch port: train a reduced SmolLM on synthetic
data, checkpoint, reload, and generate a few tokens (the port's
counterpart of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py               # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain versions

The checkpoint is written in the reference's layout
(``bridge.params_to_numpy``), so the JAX package's
``training/checkpoint.py`` reads it too, into a temporary directory
unless ``--ckpt`` names a file.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.device import resolve_device, torch_dtype  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.training.data import SyntheticLM  # noqa: E402
from repro_torch.training.optimizer import adamw_init  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402
from repro_torch.training.tree import leaves  # noqa: E402


def main(steps: int = 60, device="cuda", ckpt=None, new_tokens: int = 10):
    """Train ``steps`` steps, round-trip a checkpoint, serve one request;
    returns (the ce of each logged step, the generated tokens)."""
    dev = resolve_device(device)
    cfg = get_smoke_config("smollm-360m")
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n = sum(p.numel() for p in leaves(params))
    print(f"model {cfg.name}: {n/1e6:.2f}M params, device={dev}")

    opt = adamw_init(params)
    step = make_train_step(model, base_lr=3e-3, warmup=min(10, steps),
                           total_steps=max(steps, 2))
    data = SyntheticLM(cfg.vocab_size, seq_len=64, global_batch=8, seed=0)
    ces = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(i).items()}
        params, opt, metrics = step(params, opt, batch)
        if i % 10 == 0 or i == steps - 1:
            ces.append(float(metrics["ce"]))
            print(f"step {i:3d}  ce={ces[-1]:.3f}  "
                  f"gnorm={float(metrics['grad_norm']):.2f}  "
                  f"lr={float(metrics['lr']):.2e}")

    with tempfile.TemporaryDirectory() as tmp:
        path = ckpt or os.path.join(tmp, "quickstart_ckpt.npz")
        checkpoint.save(path, params_to_numpy(params, cfg))
        back = params_from_numpy(
            checkpoint.restore(path, params_to_numpy(params, cfg)), cfg, dev,
            torch_dtype(cfg.dtype))
    assert all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                 leaves(params)))
    print("checkpoint roundtrip OK")

    eng = ServingEngine(cfg, params=back, max_batch=2, cache_len=80,
                        device=dev)
    eng.submit(Request(id=0, prompt=[5, 17, 31], max_new_tokens=new_tokens))
    done = eng.run()
    print(f"generated: {done[0].out_tokens}")
    return ces, done[0].out_tokens


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's kernels) or cpu (the plain "
                         "versions)")
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args()
    main(steps=args.steps, device=args.device, ckpt=args.ckpt)
