"""Blocks and segment stacking.

Port of ``repro/models/transformer.py`` for ``attn``, ``swa``
(sliding-window attention; the same leaves and MLP as ``attn``),
``cross`` (cross-attention to image patches, ``xattn``, and an MLP),
``mamba1`` and ``mamba2`` blocks in the ``decode`` and ``chunk`` modes,
over paged pools (``paged`` given) or dense slot caches
(``paged=None``), and in ``prefill`` mode (a whole prompt at once into
dense caches).  A decoder block of an encoder-decoder model
(``enc_xattn``, ``ln_x``) also cross-attends to the encoder's output
after its self-attention.  The MLP after
an attention block is SwiGLU (``mlp_kind="dense"``) or the
capacity-routed mixture of experts of ``models/moe.py``
(``mlp_kind="moe"``).  A model is a
``block_pattern``; contiguous runs of one kind are *segments*, whose
parameters are stacked along a leading layer dim as in the reference.
Where the reference scans a segment with ``lax.scan``, the port runs a
Python loop over its layers, handing each layer views of its weights
(packed quant leaves included: ``_layer`` recurses into their
``{"q","s"}`` dicts) and of its slice of the in-place updated caches
(KV pools or rows, or a Mamba layer's ``h`` / ``conv`` state).

Weight-shared blocks (zamba2's ``shared_block_kind``): every position
of that kind is a one-layer segment of its own, with its own cache, and
all of them run the one parameter set ``blocks["shared"]`` (a leading
layer dim of 1, as every port segment has), drawn once; its entry in
``blocks["segments"]`` is None, as in the reference.

In ``train`` mode (every block kind over a whole sequence, no cache)
each block runs under ``torch.utils.checkpoint`` (non-reentrant), the
counterpart of the reference's ``jax.checkpoint``: its activations are
recomputed in the backward pass, its kernels launched again (the flash
and RMSNorm kernels, the cross form, the selective scan with its
checkpoints).  A train-mode block also returns its MoE aux terms (the
reference's per-block ``aux``), which :func:`apply_segments` sums over
layers and segments; the serving modes discard them.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import _dense_init, add_rmsnorm, mlp, rmsnorm

MODES = ("decode", "chunk", "train", "prefill")
KINDS = ("attn", "swa", "cross", "mamba1", "mamba2")   # all the reference's
MAMBA_KINDS = ("mamba1", "mamba2")


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


def encoder_config(cfg):
    """The encoder stack's config: ``n_encoder_layers`` attn layers, no
    cross-attention of its own (the reference's ``enc_cfg``)."""
    return dataclasses.replace(
        cfg, n_layers=cfg.n_encoder_layers,
        block_pattern=tuple(["attn"] * cfg.n_encoder_layers),
        is_encoder_decoder=False, shared_block_kind="")


def _has_mlp(kind: str, cfg) -> bool:
    return kind in ("attn", "swa", "cross") and cfg.mlp_kind != "none"


def check_supported(cfg, mode: Optional[str] = None) -> None:
    """Raise for configurations whose blocks the port cannot run (in
    ``mode``, where given: every block kind of :data:`KINDS` runs in
    every mode of :data:`MODES`)."""
    for seg in build_segments(cfg):
        if seg.kind not in KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {seg.kind!r} is not ported yet; "
                f"the port runs {KINDS} blocks")


def segment_slices(cfg, lo: int, hi: int):
    """Map decoder layers [lo, hi) onto the segment list.

    Returns [(seg_index, a, b)]: full-model segment ``seg_index``
    contributes its local layers [a, b).  Stage boundaries may fall
    inside a segment (inside gemma3's group of five ``swa`` layers, say),
    in which case the stacked params/caches are sliced along their
    leading layer dim.
    """
    if not 0 <= lo < hi <= cfg.n_layers:
        raise ValueError(f"layer range [{lo}, {hi}) outside "
                         f"[0, {cfg.n_layers})")
    out = []
    base = 0
    for i, seg in enumerate(build_segments(cfg)):
        a, b = max(lo, base), min(hi, base + seg.length)
        if a < b:
            out.append((i, a - base, b - base))
        base += seg.length
    return out


def segment_range(cfg, lo: int, hi: int) -> List[Segment]:
    """Segment list restricted to decoder layers [lo, hi)."""
    segs = build_segments(cfg)
    return [Segment(segs[i].kind, b - a, segs[i].shared)
            for i, a, b in segment_slices(cfg, lo, hi)]


def slice_blocks(blocks: dict, cfg, lo: int, hi: int) -> dict:
    """Restrict a ``{"segments", "shared"}`` param tree to layers [lo, hi).

    The result aligns with :func:`segment_range` and holds *only* the
    stage's parameters, as views of the stacked tensors (a one-layer
    slice keeps its leading layer dim, as every segment of the port
    does), plus the shared set, the same tensors in every stage: a
    pipeline stage sliced this way owns nothing outside its layer range,
    and the stages together hold no second copy of any weight."""
    segments = blocks["segments"]
    return {"segments": [None if segments[i] is None
                         else _layer(segments[i], slice(a, b))
                         for i, a, b in segment_slices(cfg, lo, hi)],
            "shared": blocks["shared"]}


def block_init(generator, kind: str, cfg, dtype, device, n: int,
               has_enc_cross: bool = False) -> dict:
    """``n`` stacked layers of one block kind (the reference's
    ``block_init`` vmapped over a segment); ``has_enc_cross`` gives an
    attn block an encoder-decoder's ``ln_x`` and ``enc_xattn``."""
    d = cfg.d_model
    p = {"ln1": {"scale": torch.ones((n, d), dtype=dtype, device=device)}}
    if kind in ("attn", "swa"):
        p["attn"] = attn_mod.attention_init(generator, cfg, dtype, device, n)
    elif kind == "cross":
        p["xattn"] = attn_mod.attention_init(generator, cfg, dtype, device, n,
                                             cross=True)
    elif kind == "mamba1":
        p["mamba"] = ssm_mod.mamba1_init(generator, cfg, dtype, device, n)
    elif kind == "mamba2":
        p["mamba"] = ssm_mod.mamba2_init(generator, cfg, dtype, device, n)
    else:
        raise NotImplementedError(kind)
    if has_enc_cross and kind in ("attn", "swa"):
        p["ln_x"] = {"scale": torch.ones((n, d), dtype=dtype, device=device)}
        p["enc_xattn"] = attn_mod.attention_init(generator, cfg, dtype,
                                                 device, n, cross=True)
    if _has_mlp(kind, cfg) and cfg.mlp_kind == "moe":
        p["ln2"] = {"scale": torch.ones((n, d), dtype=dtype, device=device)}
        p["moe"] = moe_mod.moe_init(generator, cfg, dtype, device, n)
    elif _has_mlp(kind, cfg):
        p["ln2"] = {"scale": torch.ones((n, d), dtype=dtype, device=device)}
        p["mlp"] = {
            "w_gate": _dense_init(generator, (n, d, cfg.d_ff), dtype, device),
            "w_up": _dense_init(generator, (n, d, cfg.d_ff), dtype, device),
            "w_down": _dense_init(generator, (n, cfg.d_ff, d), dtype, device),
        }
    return p


def init_segments(generator, cfg, dtype, device,
                  has_enc_cross: bool = False) -> dict:
    """Every segment's stacked layers, and the weight-shared block's one
    layer, drawn once (None where no kind is shared)."""
    segments, shared = [], None
    for seg in build_segments(cfg):
        if seg.shared:
            if shared is None:
                shared = block_init(generator, seg.kind, cfg, dtype, device,
                                    1, has_enc_cross)
            segments.append(None)
        else:
            segments.append(block_init(generator, seg.kind, cfg, dtype,
                                       device, seg.length, has_enc_cross))
    return {"segments": segments, "shared": shared}


def _cross_kv(params, cache, paged, source, *, mode: str, src: int, cfg):
    """The source K/V a cross-attention reads.  Decode and chunk: the
    cross caches (``paged``: the cross pools through the rows' cross
    tables).  Prefill and train: projected from ``source`` (image
    patches, or the encoder's output) and, in prefill, also written into
    the cross caches in place (the reference's prefill ``cache_out``)."""
    if mode in ("decode", "chunk"):
        if paged is not None:
            return attn_mod.paged_cross_view(cache, paged, src)
        return {"k": cache["xk"], "v": cache["xv"]}
    if source is None:
        raise ValueError(f"{cfg.name}: a {mode} forward of a cross-attention "
                         f"needs batch['frontend']")
    kv = attn_mod.make_cross_kv(params, source, cfg)
    if cache is not None:
        cache["xk"].copy_(kv["k"])
        cache["xv"].copy_(kv["v"])
    return kv


def _seed_attn_cache(kv: dict, cache: dict, kind: str) -> None:
    """Write a prefill's K/V (B, S, KV, hd) into one layer's dense cache
    of ``s_cache`` slots in place (the reference's ``_seed_attn_cache``):
    a ``swa`` prompt longer than its ring keeps its last ``s_cache``
    positions, rotated so that position p sits at slot ``p % s_cache``;
    otherwise the last ``min(S, s_cache)`` positions from slot 0, the
    rest zero."""
    s_cache, s_new = cache["k"].shape[1], kv["k"].shape[1]
    for name in ("k", "v"):
        new, dst = kv[name], cache[name]
        if kind == "swa" and s_new > s_cache:
            start = s_new - s_cache
            dst.copy_(torch.roll(new[:, start:], start % s_cache, dims=1))
        else:
            n = min(s_new, s_cache)
            dst[:, :n] = new[:, s_new - n:]
            dst[:, n:] = 0


def block_apply(params: dict, x, delta=None, *, kind: str, cfg, mode: str,
                pos=None, cache: Optional[dict] = None,
                paged: Optional[dict] = None,
                qformat: Optional[str] = None, positions=None,
                frontend=None, enc_src=None, causal: bool = True):
    """Apply one ``attn``, ``swa``, ``cross``, ``mamba1`` or ``mamba2``
    block to the residual stream ``x`` plus ``delta``, the previous
    block's output not yet added to it (None before the first block).
    ``pos`` is a (B,) int32 tensor in decode mode; in chunk mode an
    ``int`` (one request's prefill chunk) or a (B,) tensor (B rows at
    their own positions, the draft-verify round), which the attention
    passes on to its kernels without reading it on the host.  In train
    and prefill mode ``positions`` (B|1, S) are the rotary positions of
    a whole sequence (``causal`` False for an encoder), and a prefill
    seeds the layer's dense cache in place where one is given (its attn
    K/V, the cross K/V of ``frontend`` (B, src, D) or of the encoder's
    output ``enc_src``, its Mamba state from zero).  ``cache`` holds
    this layer's pools (``paged`` given: the block tables) or dense
    cache rows
    (``paged=None``), or a Mamba layer's ``h`` / ``conv`` state rows;
    each is written in place.  ``qformat`` tags the weight format the
    params were packed to; dispatch is structural (``qdot`` routes on
    packed leaf or tensor, and Mamba weights are never packed), so the
    tag only travels with the call, as in the reference.

    Each residual add the reference makes (``x + a``) is fused into the
    norm that reads its result: ``add_rmsnorm`` returns both, in one
    kernel launch (an encoder-decoder's self-attention output into
    ``ln_x``, its cross-attention output into ``ln2``).  The block's own
    output is not added here; it is returned as the next pending delta.
    Returns (x, delta); in train mode (x, delta, aux), aux the MoE
    layer's ``{"moe_aux_loss", "moe_drop_frac"}`` or None without one."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not ported yet; "
                         f"ported: {MODES}")
    if delta is None:
        h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    else:
        x, h = add_rmsnorm(params["ln1"], x, delta, cfg.norm_eps)
    train = mode == "train"
    if kind == "cross":
        xkv = _cross_kv(params["xattn"], cache, paged, frontend, mode=mode,
                        src=cfg.n_image_tokens or cfg.encoder_seq, cfg=cfg)
        a = attn_mod.cross_attention(params["xattn"], h, xkv, cfg,
                                     decode=mode == "decode", train=train)
    elif kind in MAMBA_KINDS:
        step, seq = ((ssm_mod.mamba1_step, ssm_mod.mamba1_seq)
                     if kind == "mamba1"
                     else (ssm_mod.mamba2_step, ssm_mod.mamba2_seq))
        if mode == "decode":
            a, _ = step(params["mamba"], h, (cache["h"], cache["conv"]), cfg)
        elif train:                    # from zero state, no cache
            a, _ = seq(params["mamba"], h, cfg, train=True)
        else:
            if mode == "prefill":      # a whole prompt starts from zero
                cache["h"].zero_()
                cache["conv"].zero_()
            a, _ = seq(params["mamba"], h, cfg, h0=cache["h"],
                       conv_state=cache["conv"])
    elif mode in ("train", "prefill"):
        a, kv = attn_mod.self_attention(params["attn"], h, positions, cfg,
                                        kind, causal=causal)
        if cache is not None:
            _seed_attn_cache(kv, cache, kind)
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
    if "enc_xattn" in params:          # an encoder-decoder's decoder block
        x, hx = add_rmsnorm(params["ln_x"], x, a, cfg.norm_eps)
        xkv = _cross_kv(params["enc_xattn"], cache, paged, enc_src,
                        mode=mode, src=cfg.encoder_seq, cfg=cfg)
        a = attn_mod.cross_attention(params["enc_xattn"], hx, xkv, cfg,
                                     decode=mode == "decode", train=train)
    aux = None
    if _has_mlp(kind, cfg):
        x, h2 = add_rmsnorm(params["ln2"], x, a, cfg.norm_eps)
        if "moe" in params:
            # the expert output is the pending delta, as the dense MLP's
            # is; the serving modes read no aux
            a, aux = moe_mod.moe_apply(params["moe"], h2, cfg)
        else:
            a = mlp(params["mlp"], h2)
    return (x, a, aux) if train else (x, a)


def _layer(tree, j):
    """Layer ``j`` (an index, or a slice of layers) of a stacked
    parameter/cache tree (views, no copies); a packed quant leaf
    ``{"q","s"}`` is a dict and slices leaf by leaf."""
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
                   qformat: Optional[str] = None, positions=None,
                   delta=None, frontend=None, enc_src=None,
                   causal: bool = True):
    """Run every layer in order, a weight-shared segment on
    ``blocks["shared"]``.  ``caches`` is the per-segment list of
    ``{"k","v"}`` pools or dense caches, or ``{"h","conv"}`` SSM state,
    with a leading layer dim; each layer writes its slice in place, so
    the list needs no rebuilding.  In train mode there are no caches:
    each block runs under a non-reentrant checkpoint at ``positions``,
    which carries the (x, delta) pair across its boundary.  ``delta``
    is the pending output of the block before the first one run here
    (a pipeline stage's input pair; None at the model's first block).
    Returns (x, delta): the residual stream and the last block's output,
    not yet added to it (the caller fuses that add into the final norm,
    or adds it, or hands the pair to the next stage); in train mode (x,
    delta, aux), aux the MoE terms summed over the layers of each
    segment and then over the segments, as the reference sums them (zero
    without MoE layers).  In prefill mode
    each layer also seeds its slice of ``caches`` (None: nothing is
    kept, as for an encoder, whose stack runs non-causal with ``causal``
    False);
    ``frontend`` and ``enc_src`` are the sources of the cross-attentions
    (see :func:`block_apply`)."""
    seg_params = [blocks["shared"] if seg.shared else p
                  for seg, p in zip(segs, blocks["segments"])]
    if mode == "train":
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        total = {"moe_aux_loss": zero, "moe_drop_frac": zero}
        for seg, params in zip(segs, seg_params):
            block = functools.partial(block_apply, kind=seg.kind, cfg=cfg,
                                      mode=mode, positions=positions,
                                      qformat=qformat, frontend=frontend,
                                      enc_src=enc_src, causal=causal)
            seg_aux = None
            for layer in _unbind(params, seg.length):
                x, delta, aux = checkpoint(block, layer, x, delta,
                                           use_reentrant=False,
                                           preserve_rng_state=False)
                if aux is not None:
                    seg_aux = aux if seg_aux is None else {
                        k: seg_aux[k] + aux[k] for k in seg_aux}
            if seg_aux is not None:
                total = {k: total[k] + seg_aux[k] for k in total}
        return x, delta, total
    whole = (dict(positions=positions, frontend=frontend, enc_src=enc_src,
                  causal=causal) if mode == "prefill" else {})
    for seg, params, cache in zip(segs, seg_params,
                                  caches or [None] * len(segs)):
        for j in range(seg.length):
            x, delta = block_apply(
                _layer(params, j), x, delta, kind=seg.kind, cfg=cfg,
                mode=mode, pos=pos,
                cache=None if cache is None else _layer(cache, j),
                paged=paged, qformat=qformat, **whole)
    return x, delta
