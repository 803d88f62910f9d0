"""Carry the JAX package's parameters into the port.

The reference model's parameters are a pytree: ``embed.w`` (the padded
vocab table, also the head when embeddings are tied), ``lm_head.w`` (an
untied head of the same layout), ``blocks.segments[i]`` stacked
``(n_layers, ...)`` per segment (a one-layer segment is stored
unstacked) — attn blocks with ``ln1.scale``, ``attn.{wq,wk,wv,wo}``,
``ln2.scale`` and ``mlp.{w_gate,w_up,w_down}``, Mamba1 blocks with
``ln1.scale`` and ``mamba.{in_proj,conv_w,conv_b,x_proj,dt_proj,
dt_bias,A_log,D,out_proj}`` — ``blocks.shared`` (None for these
models) and ``final_norm.scale``.  :func:`params_from_numpy` takes that
tree as nested dicts and lists of numpy arrays (a caller holding JAX
arrays maps ``np.asarray`` over it first) and returns the port's
parameters: the same tree of torch tensors, in the same ``(in, out)``
orientation, so the bridge copies and never transposes.  Float leaves
take the model dtype, except those the reference keeps in float32
whatever the model dtype (``A_log`` and ``D``, ``ssm.F32_LEAVES``),
which stay float32.  Projection weights the reference packed
(``quantize_params``) arrive as ``{"q", "s"}`` dicts and stay packed:
``q`` keeps its int8 / uint8 integers and ``s`` its f32 scales,
whatever the model dtype.  :func:`params_to_numpy` is the reverse
direction: port params as the reference's tree of numpy arrays (float
leaves as float32, one-layer segments unstacked), which the JAX package
takes as its parameters or restores a port checkpoint into.  It imports
no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.quantize import is_quantized
from repro_torch.models.ssm import F32_LEAVES
from repro_torch.models.transformer import build_segments


def _to_torch(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _packed_to_torch(w: dict, device) -> dict:
    q = np.asarray(w["q"])
    if q.dtype not in (np.int8, np.uint8):
        raise TypeError(f"packed weight with q of dtype {q.dtype}")
    return {"q": torch.from_numpy(np.array(q)).to(device),
            "s": torch.from_numpy(np.array(w["s"], dtype=np.float32)).to(
                device)}


def _map(tree, fn, key=None):
    """Apply ``fn(leaf, key)`` to every leaf, ``key`` being the leaf's
    own name; a packed ``{"q","s"}`` dict is one leaf."""
    if isinstance(tree, dict) and not is_quantized(tree):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    return fn(tree, key)


def params_from_numpy(tree: dict, cfg, device, dtype) -> dict:
    """The reference's parameter tree (numpy leaves) as port params."""
    segs = build_segments(cfg)
    if tree["blocks"].get("shared") is not None:
        raise NotImplementedError("weight-shared blocks are not ported yet")
    if len(tree["blocks"]["segments"]) != len(segs):
        raise ValueError(f"{len(tree['blocks']['segments'])} segments in the "
                         f"tree, {len(segs)} in {cfg.name}")

    def leaf(a, key=None):
        if is_quantized(a):
            return _packed_to_torch(a, device)
        return _to_torch(a, device,
                         torch.float32 if key in F32_LEAVES else dtype)

    def unsqueeze(a, key=None):
        if is_quantized(a):
            return {k: np.asarray(v)[None] for k, v in a.items()}
        return np.asarray(a)[None]

    segments = []
    for seg, p in zip(segs, tree["blocks"]["segments"]):
        # a one-layer segment is unstacked in the reference: add the
        # layer dim so every segment indexes the same way
        stacked = p if seg.length > 1 else _map(p, unsqueeze)
        segments.append(_map(stacked, leaf))
    out = {"embed": {"w": leaf(tree["embed"]["w"])},
           "blocks": {"segments": segments, "shared": None},
           "final_norm": {"scale": leaf(tree["final_norm"]["scale"])}}
    if "lm_head" in tree:
        out["lm_head"] = {"w": leaf(tree["lm_head"]["w"])}
    return out


def params_to_numpy(params: dict, cfg) -> dict:
    """Port params as the reference's parameter tree of numpy arrays:
    float leaves as float32 (numpy has no bfloat16; the values are
    exact), packed ``{"q","s"}`` leaves as they are, and a one-layer
    segment unstacked, as the reference stores it."""
    segs = build_segments(cfg)

    def leaf(a, key=None):
        if is_quantized(a):
            return {k: v.detach().cpu().numpy() for k, v in a.items()}
        return a.detach().to(torch.float32).cpu().numpy()

    def unstack(a, key=None):
        if is_quantized(a):
            return {k: v[0] for k, v in a.items()}
        return a[0]

    segments = []
    for seg, p in zip(segs, params["blocks"]["segments"]):
        tree = _map(p, leaf)
        segments.append(tree if seg.length > 1 else _map(tree, unstack))
    out = {"embed": {"w": leaf(params["embed"]["w"])},
           "blocks": {"segments": segments, "shared": None},
           "final_norm": {"scale": leaf(params["final_norm"]["scale"])}}
    if "lm_head" in params:
        out["lm_head"] = {"w": leaf(params["lm_head"]["w"])}
    return out
