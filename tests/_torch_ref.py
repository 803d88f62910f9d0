"""Shared fixtures of the PyTorch port's tests (tests/test_torch_*.py):
matching smoke configs for the JAX package and the port, the JAX
model's parameters carried into the port through numpy, and the pieces
the wiring tests of the fused residual add need (a count of the model's
norm calls, the block composed as it was before the fusion, and
``chip_smoke.py``'s launch formula).  Importing it caps torch's threads
at ``TORCH_THREADS``."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as torch_smoke

#: torch's intra-op threads in a test process of the port: the suite runs
#: in several xdist workers on one box, where torch's default of a thread
#: per core in every worker oversubscribes the cores
TORCH_THREADS = 1
torch.set_num_threads(TORCH_THREADS)

#: the smoke reduction makes smollm MHA (4 heads over 4 KV heads); the
#: GQA variant keeps G = 3 query heads per KV head, as the full model has
GQA = dict(n_heads=6, n_kv_heads=2, head_dim=32)
#: the falcon-mamba smoke model (2 Mamba1 layers, untied head), and a
#: hybrid of Mamba1 and attn blocks (with SwiGLU MLPs after attn) on its
#: widths
HYBRID = dict(n_layers=3, block_pattern=("mamba1", "attn", "mamba1"),
              mlp_kind="dense")
CONFIGS = {"mha": ("smollm-360m", {}), "gqa": ("smollm-360m", GQA),
           "mamba": ("falcon-mamba-7b", {}),
           "hybrid": ("falcon-mamba-7b", HYBRID)}


def config_pair(name: str):
    """(JAX config, port config) of one smoke variant."""
    arch, over = CONFIGS[name]
    jc = dataclasses.replace(jax_smoke(arch), **over)
    tc = dataclasses.replace(torch_smoke(arch), **over)
    return jc, tc


def jax_params(cfg, seed: int = 0):
    """The JAX model's parameters as a tree of numpy arrays."""
    params = build_model(cfg).init(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def bridged(np_params, tcfg):
    return params_from_numpy(np_params, tcfg, "cpu", torch.float32)


def t(a):
    """numpy -> CPU torch tensor (a copy), keeping the dtype."""
    return torch.from_numpy(np.array(a))


def count_norm_calls(monkeypatch) -> dict:
    """Count the model's calls of the RMSNorm wrappers from now on: with
    a residual delta (``add_norm``) and without (``norm``)."""
    from repro_torch.models import layers
    calls = {"add_norm": 0, "norm": 0}

    def counted(body, fn):
        def wrapper(*args, **kwargs):
            calls[body] += 1
            return fn(*args, **kwargs)
        return wrapper
    monkeypatch.setattr(layers, "rmsnorm_kernel",
                        counted("norm", layers.rmsnorm_kernel))
    monkeypatch.setattr(layers, "add_rmsnorm_kernel",
                        counted("add_norm", layers.add_rmsnorm_kernel))
    return calls


def unfused_block_apply(params, x, delta=None, *, kind, cfg, mode, pos,
                        cache, paged=None, qformat=None):
    """``transformer.block_apply`` as it composed a block before the
    residual adds were fused into the norms: the plain norm before each
    branch, and each branch's output added to x at once.  Returns (x,
    None): nothing is left pending."""
    from repro_torch.kernels.rmsnorm import rmsnorm_plain
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.layers import mlp
    assert delta is None
    h = rmsnorm_plain(x, params["ln1"]["scale"], cfg.norm_eps)
    if kind in ("mamba1", "mamba2"):
        step, seq = ((ssm_mod.mamba1_step, ssm_mod.mamba1_seq)
                     if kind == "mamba1"
                     else (ssm_mod.mamba2_step, ssm_mod.mamba2_seq))
        a, _ = (step(params["mamba"], h, (cache["h"], cache["conv"]), cfg)
                if mode == "decode" else
                seq(params["mamba"], h, cfg, h0=cache["h"],
                    conv_state=cache["conv"]))
    elif mode == "decode" and paged is None:
        a, _ = attn_mod.decode_self_attention(params["attn"], h, cache, pos,
                                              cfg, kind)
    elif mode == "decode":
        a, _ = attn_mod.paged_decode_self_attention(params["attn"], h, cache,
                                                    paged, pos, cfg, kind)
    elif paged is None:
        a, _ = attn_mod.chunk_self_attention(params["attn"], h, cache, pos,
                                             cfg, kind)
    else:
        a, _ = attn_mod.paged_chunk_self_attention(params["attn"], h, cache,
                                                   paged, pos, cfg, kind)
    x = x + a
    if "mlp" not in params:
        return x, None
    h2 = rmsnorm_plain(x, params["ln2"]["scale"], cfg.norm_eps)
    return x + mlp(params["mlp"], h2), None


def expected_norm_calls(cfg, iters: int, chunks: int) -> dict:
    """The model's norm calls with and without a delta that
    ``chip_smoke.py``'s launch formula implies for ``iters`` decode
    iterations and ``chunks`` prefill chunks."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from repro_torch.kernels import _build
    launches, bodies = chip_smoke.expected_launches(
        cfg, False, None, iters, chunks, _build.launches)
    norms = bodies["rmsnorm"]
    assert launches["rmsnorm"] == sum(norms.values())
    return {"add_norm": norms["add_norm"], "norm": norms["norm"]}
