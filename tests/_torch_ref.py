"""Shared fixtures of the PyTorch port's tests (tests/test_torch_*.py):
matching smoke configs for the JAX package and the port, and the JAX
model's parameters carried into the port through numpy."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as torch_smoke

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
