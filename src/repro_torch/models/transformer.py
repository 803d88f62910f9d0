"""Blocks and segment stacking.

Port of ``repro/models/transformer.py`` for ``attn``, ``swa``
(sliding-window attention; the same leaves and MLP as ``attn``) and
``mamba1`` blocks in the ``decode`` and ``chunk`` modes, over paged pools
(``paged`` given) or dense slot caches (``paged=None``).  A model is a
``block_pattern``; contiguous runs of one kind are *segments*, whose
parameters are stacked along a leading layer dim as in the reference.
Where the reference scans a segment with ``lax.scan``, the port runs a
Python loop over its layers, handing each layer views of its weights
(packed quant leaves included: ``_layer`` recurses into their
``{"q","s"}`` dicts) and of its slice of the in-place updated caches
(KV pools or rows, or a Mamba1 layer's ``h`` / ``conv`` state).

In ``train`` mode (``attn`` and ``swa`` blocks over a whole sequence, no
cache) each block runs under ``torch.utils.checkpoint`` (non-reentrant),
the counterpart of the reference's ``jax.checkpoint``: its activations
are recomputed in the backward pass, the flash and RMSNorm kernels
launched again.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import _dense_init, add_rmsnorm, mlp, rmsnorm

MODES = ("decode", "chunk", "train")
KINDS = ("attn", "swa", "mamba1")   # block kinds the port runs


@dataclass(frozen=True)
class Segment:
    kind: str
    length: int
    shared: bool


def build_segments(cfg) -> List[Segment]:
    segs: List[Segment] = []
    for b in cfg.block_pattern:
        shared = b == cfg.shared_block_kind
        if segs and segs[-1].kind == b and not shared and not segs[-1].shared:
            segs[-1] = Segment(b, segs[-1].length + 1, False)
        else:
            segs.append(Segment(b, 1, shared))
    return segs


def _has_mlp(kind: str, cfg) -> bool:
    return kind in ("attn", "swa", "cross") and cfg.mlp_kind != "none"


def check_supported(cfg, mode: Optional[str] = None) -> None:
    """Raise for configurations whose blocks the port cannot run yet (in
    ``mode``, where given)."""
    if mode == "train" and "mamba1" in cfg.block_pattern:
        raise NotImplementedError(
            f"{cfg.name}: Mamba1 training is not ported yet (ROADMAP Queue "
            f"1 item 9: the selective scan's gradient)")
    for seg in build_segments(cfg):
        if seg.kind not in KINDS or seg.shared:
            raise NotImplementedError(
                f"{cfg.name}: block kind {seg.kind!r}"
                f"{' (weight-shared)' if seg.shared else ''} is not "
                f"ported yet; the port runs {KINDS} blocks")
    if cfg.mlp_kind not in ("dense", "none") or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: mlp {cfg.mlp_kind!r} / encoder-decoder is not "
            f"ported yet")


def block_init(generator, kind: str, cfg, dtype, device, n: int) -> dict:
    """``n`` stacked layers of one block kind (the reference's
    ``block_init`` vmapped over a segment)."""
    d = cfg.d_model
    p = {"ln1": {"scale": torch.ones((n, d), dtype=dtype, device=device)}}
    if kind in ("attn", "swa"):
        p["attn"] = attn_mod.attention_init(generator, cfg, dtype, device, n)
    elif kind == "mamba1":
        p["mamba"] = ssm_mod.mamba1_init(generator, cfg, dtype, device, n)
    else:
        raise NotImplementedError(kind)
    if _has_mlp(kind, cfg):
        p["ln2"] = {"scale": torch.ones((n, d), dtype=dtype, device=device)}
        p["mlp"] = {
            "w_gate": _dense_init(generator, (n, d, cfg.d_ff), dtype, device),
            "w_up": _dense_init(generator, (n, d, cfg.d_ff), dtype, device),
            "w_down": _dense_init(generator, (n, cfg.d_ff, d), dtype, device),
        }
    return p


def init_segments(generator, cfg, dtype, device) -> dict:
    return {"segments": [block_init(generator, seg.kind, cfg, dtype, device,
                                    seg.length)
                         for seg in build_segments(cfg)],
            "shared": None}


def block_apply(params: dict, x, delta=None, *, kind: str, cfg, mode: str,
                pos=None, cache: Optional[dict] = None,
                paged: Optional[dict] = None,
                qformat: Optional[str] = None, positions=None):
    """Apply one ``attn``, ``swa`` or ``mamba1`` block to the residual
    stream ``x`` plus ``delta``, the previous block's output not yet added
    to it (None before the first block).  ``pos`` is a (B,) int32 tensor in
    decode mode; in chunk mode an ``int`` (one request's prefill chunk)
    or a (B,) tensor (B rows at their own positions, the draft-verify
    round), which the attention passes on to its kernels without reading
    it on the host.  In train mode ``positions`` (B|1, S) are the
    rotary positions of a whole sequence and there is no cache.
    ``cache`` holds this layer's
    pools (``paged`` given: the block tables) or dense cache rows
    (``paged=None``), or a Mamba1 layer's ``h`` / ``conv`` state rows;
    each is written in place.  ``qformat`` tags the weight format the
    params were packed to; dispatch is structural (``qdot`` routes on
    packed leaf or tensor, and Mamba1 weights are never packed), so the
    tag only travels with the call, as in the reference.

    Each residual add the reference makes (``x + a``) is fused into the
    norm that reads its result: ``add_rmsnorm`` returns both, in one
    kernel launch.  The block's own output is not added here; it is
    returned as the next pending delta.  Returns (x, delta)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not ported yet; "
                         f"ported: {MODES}")
    if delta is None:
        h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    else:
        x, h = add_rmsnorm(params["ln1"], x, delta, cfg.norm_eps)
    if kind == "mamba1":
        if mode == "decode":
            a, _ = ssm_mod.mamba1_step(params["mamba"], h,
                                       (cache["h"], cache["conv"]), cfg)
        else:
            a, _ = ssm_mod.mamba1_seq(params["mamba"], h, cfg,
                                      h0=cache["h"],
                                      conv_state=cache["conv"])
    elif mode == "train":
        a, _ = attn_mod.self_attention(params["attn"], h, positions, cfg,
                                       kind)
    elif mode == "decode":
        if paged is None:
            a, _ = attn_mod.decode_self_attention(
                params["attn"], h, cache, pos, cfg, kind)
        else:
            a, _ = attn_mod.paged_decode_self_attention(
                params["attn"], h, cache, paged, pos, cfg, kind)
    elif paged is None:
        a, _ = attn_mod.chunk_self_attention(
            params["attn"], h, cache, pos, cfg, kind)
    else:
        a, _ = attn_mod.paged_chunk_self_attention(
            params["attn"], h, cache, paged, pos, cfg, kind)
    if not _has_mlp(kind, cfg):
        return x, a
    x, h2 = add_rmsnorm(params["ln2"], x, a, cfg.norm_eps)
    return x, mlp(params["mlp"], h2)


def _layer(tree, j: int):
    """Layer ``j`` of a stacked parameter/cache tree (views, no copies);
    a packed quant leaf ``{"q","s"}`` is a dict and slices leaf by leaf."""
    if isinstance(tree, dict):
        return {k: _layer(v, j) for k, v in tree.items()}
    return tree[j]


def _unbind(tree, n: int) -> list:
    """The ``n`` layers of a stacked parameter tree, each a tree of views
    (``unbind``: its gradient stacks the layers' gradients in one op)."""
    if isinstance(tree, dict):
        per = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[j] for k, v in per.items()} for j in range(n)]
    return list(tree.unbind(0))


def apply_segments(blocks: dict, x, *, cfg, mode: str, segs, pos=None,
                   caches: Optional[list] = None,
                   paged: Optional[dict] = None,
                   qformat: Optional[str] = None, positions=None):
    """Run every layer in order.  ``caches`` is the per-segment list of
    ``{"k","v"}`` pools or dense caches, or ``{"h","conv"}`` SSM state,
    with a leading layer dim; each layer writes its slice in place, so
    the list needs no rebuilding.  In train mode there are no caches:
    each block runs under a non-reentrant checkpoint at ``positions``,
    which carries the (x, delta) pair across its boundary.
    Returns (x, delta): the residual stream and the last block's output,
    not yet added to it (the caller fuses that add into the final norm,
    or adds it)."""
    delta = None
    if mode == "train":
        for seg, params in zip(segs, blocks["segments"]):
            block = functools.partial(block_apply, kind=seg.kind, cfg=cfg,
                                      mode=mode, positions=positions,
                                      qformat=qformat)
            for layer in _unbind(params, seg.length):
                x, delta = checkpoint(block, layer, x, delta,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
        return x, delta
    for seg, params, cache in zip(segs, blocks["segments"], caches):
        for j in range(seg.length):
            x, delta = block_apply(_layer(params, j), x, delta,
                                   kind=seg.kind, cfg=cfg, mode=mode,
                                   pos=pos, cache=_layer(cache, j),
                                   paged=paged, qformat=qformat)
    return x, delta
