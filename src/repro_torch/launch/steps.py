"""Step factories, abstract inputs and their shardings (the port of
``repro/launch/steps.py``).

``make_step(cfg, shape, mesh)`` returns ``(fn, args)``: every leaf of
``args`` is a DTensor over ``mesh`` whose local tensor is a fake tensor
(``torch._subclasses.FakeTensorMode``) on the mesh's device, laid out by
the reference's spec for that leaf, so ``fn(*args)`` runs one rank's
partitioned step with no device memory, as the reference's
``jax.jit(fn).lower(*args)`` lowers one.  ``fn`` enters its own fake
mode and ``implicit_replication`` (a plain tensor the step makes, a
position ramp or a mask, is every rank's whole copy, as a constant is
in the reference's program); the caller holds ``use_mesh_rules(mesh)``,
as the reference's dry-run does.

Specs are the reference's (``param_spec`` of each leaf's path,
``_cache_shardings``, ``input_specs``), fitted to each leaf's shape:
an axis that does not divide its dim is dropped.  The port stores every
block leaf with a leading layer dim, a one-layer segment's as 1, where
the reference stores it unstacked; that dim is never sharded, so such a
leaf's local shape is the reference's with a leading 1 and the same
bytes.
"""
from __future__ import annotations

import functools
import math
import os

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models.model import Model
from repro_torch.sharding.specs import (P, axis_sizes, fit_spec,
                                        keep_placements, param_specs,
                                        to_placements)
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_step import make_train_step

_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


def _batch_axes(mesh):
    names = tuple(mesh.mesh_dim_names)
    return ("pod", "data") if "pod" in names else ("data",)


def local_shape(shape: tuple, spec, mesh) -> tuple:
    """One rank's shape of a tensor of ``shape`` laid out by ``spec``."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        out.append(dim // math.prod(sizes[a] for a in axes))
    return tuple(out)


def _dtensor(shape, dtype, mesh, spec, fake_mode):
    """A DTensor of global ``shape`` laid out by ``spec`` (fitted to the
    shape) over ``mesh``, its local a fake tensor on the mesh's device."""
    from torch.distributed.tensor import DTensor
    spec = fit_spec(tuple(shape), spec, mesh)
    with fake_mode:
        local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                            device=mesh.device_type)
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


@functools.lru_cache(maxsize=4)
def param_struct(cfg: ModelConfig) -> dict:
    """The model's parameter tree on the ``meta`` device: ``Model.init``
    with no memory and no draws (the leaves' shapes and dtypes)."""
    from torch.overrides import TorchFunctionMode

    class _NoDraws(TorchFunctionMode):
        """``torch.randn`` as an empty meta tensor of its shape (the
        init draws on its generator's device, a real one)."""

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.randn:
                return torch.empty(args[0], device="meta",
                                   dtype=kwargs.get("dtype") or torch.float32)
            return func(*args, **kwargs)

    with _NoDraws():
        return Model(cfg, device="meta").init(torch.Generator())


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and the spec tree of its
    structure (None kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


# ----------------------------------------------------------------------
# Param / optimizer shardings
# ----------------------------------------------------------------------
def param_shardings(mesh, cfg: ModelConfig):
    """Every parameter leaf's spec, fitted to its shape
    (``sharding.specs.param_specs``: the reference's ``param_spec`` of
    its path, a stacked leaf's leading layer dim never sharded)."""
    struct = param_struct(cfg)
    return _zip_map(lambda leaf, spec: fit_spec(tuple(leaf.shape), spec,
                                                mesh),
                    struct, param_specs(struct, mesh))


def _zero1(spec, shape, mesh):
    """ZeRO-1: a moment's spec also sharded over the data axes on its
    first free dim they divide (the reference's ``zero1``)."""
    b_axes = _batch_axes(mesh)
    n_data = math.prod(axis_sizes(mesh)[a] for a in b_axes)
    spec = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, ax) in enumerate(zip(shape, spec)):
        if ax is None and dim % n_data == 0 and dim >= n_data:
            spec[i] = b_axes if len(b_axes) > 1 else b_axes[0]
            break
    return P(*spec)


def cache_spec(name: str, ndim: int, mesh, layout: str = "heads"):
    """The reference's ``_cache_shardings`` spec of a cache leaf
    ``name`` (``k``/``v`` by heads or, ``layout="seq"``, by slots;
    ``xk``/``xv`` by heads; Mamba ``h`` and ``conv`` by channels), with
    the leading layer dim."""
    b = _batch_axes(mesh)
    if name in ("k", "v"):
        if layout == "seq":
            return P(None, b, "model", None, None)
        return P(None, b, None, "model", None)
    if name in ("xk", "xv"):
        return P(None, b, None, "model", None)
    if name == "h":        # (L,B,di,ds) or (L,B,nh,hd,ds)
        spec = [None, b] + [None] * (ndim - 2)
        spec[2] = "model"
        return P(*spec)
    if name == "conv":
        return P(None, b, None, "model")
    return P(*([None] * ndim))


def _cache_shardings(mesh, cfg: ModelConfig, batch: int, seq_len: int,
                     layout: str = "heads"):
    """(shape, dtype, spec) of every leaf of the dense caches of
    ``batch`` rows and ``seq_len`` slots, in ``Model.init_cache``'s
    structure."""
    from repro_torch.models.kvcache import _leaves, _segments
    dtype = _DTYPES[cfg.dtype]
    return [{name: (shape, dt, fit_spec(shape, cache_spec(
        name, len(shape), mesh, layout), mesh))
        for name, (shape, dt) in _leaves(cfg, seg, batch, seq_len,
                                         dtype).items()}
        for seg in _segments(cfg, None)]


def _caches(mesh, cfg, batch, seq_len, layout, fake_mode, zeros=False):
    """The dense caches as DTensors (fake locals); ``zeros``: filled
    with zeros inside the step (a prefill's fresh caches)."""
    out = []
    for seg in _cache_shardings(mesh, cfg, batch, seq_len, layout):
        leaves = {}
        for name, (shape, dt, spec) in seg.items():
            t = _dtensor(shape, dt, mesh, spec, fake_mode)
            leaves[name] = t.zero_() if zeros else t
        out.append(leaves)
    return out


# ----------------------------------------------------------------------
# Abstract input specs per shape kind
# ----------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                decode_cache_layout: str = "heads", fake_mode=None):
    """DTensor stand-ins (fake locals) for every model input of this
    shape: tokens (train, prefill) and a frontend's embeddings, or
    token, pos and the caches (decode)."""
    fake_mode = fake_mode or _fake_mode()
    b = _batch_axes(mesh)
    B, S = shape.global_batch, shape.seq_len
    bf16 = torch.bfloat16

    def make(shp, dtype, spec):
        return _dtensor(shp, dtype, mesh, spec, fake_mode)
    specs = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = make((B, S), torch.int32, P(b, None))
        if cfg.n_image_tokens:
            specs["frontend"] = make((B, cfg.n_image_tokens, cfg.d_model),
                                     bf16, P(b, None, None))
        if cfg.is_encoder_decoder:
            specs["frontend"] = make((B, cfg.encoder_seq, cfg.d_model),
                                     bf16, P(b, None, None))
    else:  # decode
        specs["token"] = make((B, 1), torch.int32, P(b, None))
        specs["pos"] = make((B,), torch.int32, P(b))
        specs["cache"] = _caches(mesh, cfg, B, S, decode_cache_layout,
                                 fake_mode)
    return specs


# ----------------------------------------------------------------------
# Step functions
# ----------------------------------------------------------------------
def make_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
              decode_cache_layout: str = "heads"):
    """Returns (fn, args) with DTensor args of fake locals.

    train  : fn(params, opt_state, batch) -> (params, opt_state, metrics)
    prefill: fn(params, batch) -> (logits, cache)
    decode : fn(params, cache, batch) -> (next_token, cache)
    """
    from torch.distributed.tensor.experimental import implicit_replication
    fake_mode = _fake_mode()
    model = Model(cfg, device="cpu")   # builds nothing: args come from above
    struct = param_struct(cfg)
    pshard = param_shardings(mesh, cfg)
    params_in = _zip_map(
        lambda leaf, spec: _dtensor(tuple(leaf.shape), leaf.dtype, mesh, spec,
                                    fake_mode), struct, pshard)
    batch = input_specs(cfg, shape, mesh, decode_cache_layout, fake_mode)

    def run(body):
        def fn(*args):
            with fake_mode, implicit_replication():
                return body(*args)
        fn.fake_mode = fake_mode
        return fn

    if shape.kind == "train":
        step = make_train_step(model)
        mom = pshard
        if os.environ.get("REPRO_ZERO1"):
            mom = _zip_map(lambda leaf, spec: _zero1(spec, leaf.shape, mesh),
                           struct, pshard)

        def moment(leaf, spec):
            return _dtensor(tuple(leaf.shape), torch.float32, mesh, spec,
                            fake_mode)
        opt_in = AdamWState(
            step=_dtensor((), torch.int32, mesh, P(), fake_mode),
            mu=_zip_map(moment, struct, mom),
            nu=_zip_map(moment, struct, mom))
        return run(step), (params_in, opt_in, batch)

    if shape.kind == "prefill":
        def prefill(params, b):
            # serving prefill: populate the caches, return ONLY the
            # last-position logits (what the sampler needs)
            caches = _caches(mesh, cfg, shape.global_batch, shape.seq_len,
                             "heads", fake_mode, zeros=True)
            hidden, caches, _ = model.forward(params, b, mode="prefill",
                                              caches=caches,
                                              return_hidden=True)
            logits = hidden[:, -1] @ model.head_weight(params).T
            return logits, caches

        return run(prefill), (params_in, batch)

    cache_in = batch.pop("cache")

    def decode(params, caches, b):
        logits, caches = model.decode_step(params, caches, b)
        # greedy sampler over the logical vocab (the head is padded);
        # each rank's rows gather their vocab shards first
        logits = logits.redistribute(logits.device_mesh,
                                     keep_placements(logits, (-1,)))
        nxt = torch.argmax(logits[..., :cfg.vocab_size], dim=-1)
        return nxt.to(torch.int32), caches

    return run(decode), (params_in, cache_in, batch)
