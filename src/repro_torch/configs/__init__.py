"""Architecture config registry of the port.

It holds the architectures the port can serve so far: ``smollm-360m``
(dense attention), ``falcon-mamba-7b`` (Mamba1), ``gemma3-12b`` (dense
attention, 5 sliding-window layers to 1 global), and the mixtures of
experts ``mixtral-8x7b`` (sliding-window attention, 8 experts, top-2)
and ``kimi-k2-1t-a32b`` (384 experts, top-8), and the hybrid
``zamba2-7b`` (Mamba2 layers with one weight-shared attn block every
sixth layer), the vision-language decoder ``llama-3.2-vision-90b``
(a ``cross`` layer every fifth layer over 1601 image patch embeddings)
and the encoder-decoder ``seamless-m4t-medium`` (12 bidirectional
encoder layers over 1024 frame embeddings, 12 decoder layers each
cross-attending to the encoder's output), and the dense GQA decoders
``qwen2-72b`` (QKV bias, rope theta 1e6) and ``command-r-35b`` (a head
tied to its 256000-row embedding, rope theta 8e6), the speculation
targets.  That is every architecture of the reference's registry.
``get_config(arch_id)`` returns the production
:class:`~repro_torch.config.ModelConfig`, ``get_smoke_config`` the
reduced CPU-testable variant, ``get_shape`` one of the four assigned
input shapes and ``all_pairs`` every (arch, shape) the skip rule keeps.
"""
from __future__ import annotations

import importlib

from repro_torch.config import SHAPES, ModelConfig, ShapeConfig, reduce_config

_ARCH_MODULES = {
    "smollm-360m": "smollm_360m",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "gemma3-12b": "gemma3_12b",
    "mixtral-8x7b": "mixtral_8x7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "zamba2-7b": "zamba2_7b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen2-72b": "qwen2_72b",
    "command-r-35b": "command_r_35b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; "
                       f"known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return reduce_config(get_config(arch_id))


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_pairs():
    """All (arch, shape) pairs that are applicable per DESIGN.md rules."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            if cfg.supports_shape(s):
                out.append((a, s.name))
    return out
