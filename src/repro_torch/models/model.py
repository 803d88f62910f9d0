"""Unified model over dense or paged caches: embedding + segments +
head (tied, or an untied ``lm_head``).

Port of the serving API of ``repro/models/model.py`` for attention
decoders, Mamba1 models, the Mamba2 / weight-shared attn hybrid, the
vision decoder with ``cross`` layers and the encoder-decoder::

    m = Model(cfg, qformat=None, device="cuda")
    params = m.init(generator)                                  # or bridge
    caches = m.init_cache(batch, cache_len)                     # dense slots
    hidden, caches = m.prefill_chunk(params, caches, toks, pos0, slot)
    logits, caches = m.decode_step(params, caches, batch)
    hidden, caches = m.paged_prefill_chunk(params, pools, toks, pos0, row, meta)
    logits, caches = m.paged_decode_step(params, pools, batch, meta)
    toks = m.decode_steps(m.one_stage(params, caches), batch, meta_or_None,
                          k=K)
    emit = m.verify_steps(m.one_stage(params, caches), batch, meta_or_None)
    p = m.stage_params(params, lo, hi, entry=..., exit_head=...)  # stages
    out = m.run_stages(p, x, lo, hi, mode=..., pos=..., caches=...)
    logits, _, aux = m.forward(params, {"tokens": toks}, mode="train")
    logits, caches, aux = m.prefill(params, {"tokens": toks,
                                             "frontend": emb}, cache_len)

Dense ``caches`` are :meth:`init_cache`'s, paged ones the pools and
SSM state rows of :meth:`repro_torch.models.kvcache.PagedCache.struct`
with ``meta`` from :meth:`PagedCache.meta`; both are written **in
place** (the returned list is the one passed in).  Parameters are nested dicts of tensors in
the reference's pytree layout, per-layer weights stacked along a
leading layer dim (``bridge.params_from_numpy`` builds them from the
JAX package's parameters); ``qformat`` tags the format their projection
weights were packed to (``models/quantize.py::quantize_params``, which
the engines call), and the model never packs them itself.
:meth:`forward` is train mode (``training/train_step.py``): every block
under a checkpoint, gradients through autograd; or, with
``mode="prefill"``, a whole prompt through every block at once, seeding
dense caches (:meth:`prefill`).  A ``cross`` layer's source is
``batch["frontend"]`` (B, n_image_tokens, D) of image patch embeddings;
an encoder-decoder's is its encoder's output over ``batch["frontend"]``
(B, encoder_seq, D) of frame embeddings (:meth:`_encode`).  Only a
prefill writes real cross K/V: the engines carry no frontend and zero a
request's cross caches at admission, as the reference's do.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import transformer as tfm
from repro_torch.models.kvcache import cache_struct
from repro_torch.models.layers import (_dense_init, add_rmsnorm, embed,
                                      rmsnorm, unembed)
from repro_torch.models.quantize import normalize_format


class Model:
    def __init__(self, cfg, *, qformat: Optional[str] = None, device="cuda"):
        tfm.check_supported(cfg)
        self.cfg = cfg
        # weight format tag ("int8"/"int4", None for the unquantized
        # baseline; "bf16" means None)
        self.qformat = normalize_format(qformat)
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        self.segments = tfm.build_segments(cfg)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn from ``generator`` (normal times
        fan_in ** -0.5, norms at one, the padded embedding table at
        d_model ** -0.5, an untied ``lm_head`` like it), in the
        reference's layout.  The draws differ from ``jax.random``'s; to
        run the reference's weights, bridge them instead."""
        cfg = self.cfg

        def table():
            return {"w": _dense_init(generator,
                                     (cfg.vocab_padded, cfg.d_model),
                                     self.dtype, self.device,
                                     scale=cfg.d_model ** -0.5)}
        params = {
            "embed": table(),
            "blocks": tfm.init_segments(
                generator, cfg, self.dtype, self.device,
                has_enc_cross=cfg.is_encoder_decoder),
            "final_norm": {"scale": torch.ones(cfg.d_model, dtype=self.dtype,
                                               device=self.device)},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = table()
        if cfg.is_encoder_decoder:
            params["encoder"] = {
                "blocks": tfm.init_segments(generator, tfm.encoder_config(cfg),
                                            self.dtype, self.device),
                "final_norm": {"scale": torch.ones(
                    cfg.d_model, dtype=self.dtype, device=self.device)}}
        return params

    def _encode(self, params, frontend, mode: str = "prefill"):
        """The bidirectional encoder over frame embeddings (B, S, D): a
        stack of ``n_encoder_layers`` attn blocks (rotary at 0 .. S - 1,
        non-causal: the flash kernel's contiguous form), then its final
        norm.  ``mode="train"`` runs each block under a checkpoint, as the
        reference's ``_encode`` always does (its aux is dropped, as
        there)."""
        enc = tfm.encoder_config(self.cfg)
        b, s, _ = frontend.shape
        positions = torch.arange(s, device=frontend.device).expand(b, s)
        stream = tfm.apply_segments(
            params["encoder"]["blocks"], frontend.to(self.dtype), cfg=enc,
            mode=mode, segs=tfm.build_segments(enc),
            positions=positions, qformat=self.qformat, causal=False)
        return self._final_norm(params["encoder"], stream[:2])

    def _final_norm(self, params, stream):
        """The final norm of the stream's (x, delta): the last block's
        pending residual add fused into it."""
        x, delta = stream
        if delta is None:
            return rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return add_rmsnorm(params["final_norm"], x, delta,
                           self.cfg.norm_eps)[1]

    def _head_params(self, params) -> dict:
        return (params["embed"] if self.cfg.tie_embeddings
                else params["lm_head"])

    def _head(self, params, stream):
        """Logits from the stream's (x, delta) over the padded vocab."""
        return unembed(self._head_params(params),
                       self._final_norm(params, stream))

    def head_weight(self, params) -> torch.Tensor:
        """The LM head's table (V_pad, D): the tied embedding or the
        untied ``lm_head``."""
        return self._head_params(params)["w"]

    def forward(self, params, batch, mode: str = "train",
                caches: Optional[list] = None, return_hidden: bool = False):
        """A whole-sequence forward over batch {"tokens" (B,S) int,
        ["frontend" (B,T,D)]}: the embedding, every block (the residual
        add fused into the next norm) at positions 0 .. S - 1, the final
        norm and, unless ``return_hidden``, the head over the padded
        vocab.

        ``mode="train"``: each block under a checkpoint, no cache; aux
        holds the MoE terms summed over the layers (zero without MoE).
        ``mode="prefill"``: ``caches`` (dense, :meth:`init_cache`) are
        seeded in place as the reference's prefill does: each attn
        layer's K/V of the prompt, each Mamba layer's state after it
        (from zero), and the cross K/V of the frontend (``cross`` layers)
        or of the encoder's output over it (an encoder-decoder's
        ``enc_xattn``), so that :meth:`decode_step` / :meth:`decode_steps`
        go on from the prompt (aux: zero MoE terms, the serving modes
        discard them).  Returns (logits (B,S,V_pad) or hidden (B,S,D),
        None in train mode or the caches, aux)."""
        if mode not in ("train", "prefill"):
            raise ValueError(f"Model.forward(mode={mode!r}): the port's "
                             f"whole-sequence modes are 'train' and "
                             f"'prefill'")
        if mode == "prefill" and caches is None:
            raise ValueError("Model.forward(mode='prefill') seeds caches: "
                             "pass init_cache's")
        cfg = self.cfg
        tfm.check_supported(cfg, mode)
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed(params["embed"], tokens).to(self.dtype)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        frontend = batch.get("frontend")
        enc_src = None
        if cfg.is_encoder_decoder:
            if frontend is None:
                raise ValueError(f"{cfg.name}: the encoder needs "
                                 f"batch['frontend']")
            enc_src, frontend = self._encode(params, frontend, mode), None
        stream = tfm.apply_segments(
            params["blocks"], x, cfg=cfg, mode=mode, segs=self.segments,
            positions=positions, caches=caches, qformat=self.qformat,
            frontend=None if frontend is None else frontend.to(self.dtype),
            enc_src=enc_src)
        if mode == "train":
            aux, stream = stream[2], stream[:2]
        else:
            zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
            aux = {"moe_aux_loss": zero, "moe_drop_frac": zero}
        hidden = self._final_norm(params, stream)
        if not return_hidden:
            hidden = unembed(self._head_params(params), hidden)
        return hidden, caches, aux

    def prefill(self, params, batch, cache_len: Optional[int] = None):
        """A whole prompt batch into fresh dense caches of ``cache_len``
        slots (S by default), the reference's ``Model.prefill``: returns
        (logits (B,S,V_pad), caches, aux), the caches ready for
        :meth:`decode_step` / :meth:`decode_steps` at pos S."""
        b, s = batch["tokens"].shape
        return self.forward(params, batch, mode="prefill",
                            caches=self.init_cache(b, cache_len or s))

    def _hidden(self, params, caches, tokens, pos, paged):
        """A chunk's hidden state: it has no head, so the last pending
        residual add is one plain add."""
        x, delta = self.run_stages(
            {"embed": params["embed"], "blocks": params["blocks"]}, tokens,
            0, self.cfg.n_layers, mode="chunk", pos=pos, caches=caches,
            paged=paged)
        return x if delta is None else x + delta

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, dtype=None,
                   layers=None) -> list:
        """Dense slot caches on the model's device
        (``kvcache.cache_struct``), in the model dtype unless given;
        ``layers=(lo, hi)`` restricts them to that decoder layer range (a
        pipeline stage's slice)."""
        return cache_struct(self.cfg, batch, cache_len, dtype or self.dtype,
                            device=self.device, layers=layers)

    # ------------------------------------------------------------------
    # Pipeline-parallel stage API (serving/pipeline.py)
    # ------------------------------------------------------------------
    def one_stage(self, params, caches) -> list:
        """The stage chain of a monolithic engine: one stage over every
        layer, for :meth:`decode_steps` and :meth:`verify_steps`."""
        return [(params, 0, self.cfg.n_layers, caches)]

    def stage_params(self, params, lo: int, hi: int, *, entry: bool = False,
                     exit_head: bool = False) -> dict:
        """Parameter subtree owned by a stage running layers [lo, hi):
        views of the stacked tensors (``transformer.slice_blocks``), so
        the stages of one model hold no second copy of any weight.  The
        entry stage also owns the embedding, the exit stage the final
        norm and the LM head (the embedding table itself when tied)."""
        p = {"blocks": tfm.slice_blocks(params["blocks"], self.cfg, lo, hi)}
        if entry:
            p["embed"] = params["embed"]
        if exit_head:
            p["final_norm"] = params["final_norm"]
            p["embed" if self.cfg.tie_embeddings
              else "lm_head"] = self._head_params(params)
        return p

    def run_stages(self, stage_p, x, lo: int, hi: int, *, mode: str,
                   pos=None, caches=None, paged=None):
        """Run decoder layers [lo, hi) from :meth:`stage_params` output
        (or the whole parameter tree over [0, n_layers)), in ``decode``
        or ``chunk`` mode.

        ``x`` is token ids (B, T) for the stage at layer 0; for any
        other, the previous stage's ``(x, delta)`` pair (the residual
        stream and its last block's output, not yet added).  A stage
        whose params hold ``final_norm`` returns logits (B, T, V_pad),
        the pending add fused into the final norm; any other returns its
        ``(x, delta)`` pair.  Carrying the pair across a stage boundary
        keeps every norm launch and every bit of the monolithic forward.
        ``caches`` is the stage's slice (``init_cache(layers=)`` or
        ``PagedCache.struct(layers=)``), written in place; ``paged`` the
        ledger's meta."""
        if lo == 0:
            x, delta = embed(stage_p["embed"], x).to(self.dtype), None
        else:
            x, delta = x
        stream = tfm.apply_segments(
            stage_p["blocks"], x, cfg=self.cfg, mode=mode,
            segs=tfm.segment_range(self.cfg, lo, hi), pos=pos,
            caches=caches, paged=paged, qformat=self.qformat, delta=delta)
        if "final_norm" in stage_p:
            return self._head(stage_p, stream)
        return stream

    def _chain(self, stages, tokens, pos, paged, mode):
        """Logits of ``tokens`` through the stage chain ``stages``, a list
        of (params, lo, hi, caches) covering [0, n_layers) in order: each
        stage's :meth:`run_stages`, its ``(x, delta)`` pair handed on."""
        x = tokens
        for params, lo, hi, caches in stages:
            x = self.run_stages(params, x, lo, hi, mode=mode, pos=pos,
                                caches=caches, paged=paged)
        return x

    def prefill_chunk(self, params, caches, tokens, pos0: int, slot: int):
        """Chunked prefill of one slot against the dense caches.

        tokens: (1, C) at absolute positions pos0..; only batch row
        ``slot`` is read and written: each layer sees a view of that row
        (``caches[...][:, slot:slot + 1]``, the reference's
        ``row_isolated``), which the KV and SSM state writes update in
        place, so every other row stays bit-untouched.  Returns
        (hidden (1,C,D), caches) — no LM head: admission discards prompt
        logits.
        """
        rows = row_views(caches, self.segments, slot, paged=False)
        return self._hidden(params, rows, tokens, int(pos0), None), caches

    def decode_step(self, params, caches, batch):
        """One decode step against the dense caches: batch {"token"
        (B,1), "pos" (B,) int32}.  Returns (logits (B,1,V_pad), caches)."""
        return self._chain(self.one_stage(params, caches), batch["token"],
                           batch["pos"], None, "decode"), caches

    # ------------------------------------------------------------------
    def paged_prefill_chunk(self, params, caches, tokens, pos0: int, row: int,
                            paged):
        """Chunked prefill of one request against the pools.

        tokens: (1, C) at absolute positions pos0..; ``paged`` holds the
        request's row-sliced block tables (``meta(row=row)``), so KV
        writes land only in blocks the row owns.  SSM segments see row
        ``row`` of their state (``[:, row:row + 1]`` views, the
        reference's ``ssm_row_isolated``), written in place, so every
        other row stays bit-untouched.  Returns (hidden (1,C,D), caches)
        — no LM head: admission discards prompt logits.
        """
        rows = row_views(caches, self.segments, row, paged=True)
        return self._hidden(params, rows, tokens, int(pos0), paged), caches

    def paged_decode_step(self, params, caches, batch, paged):
        """One decode step: batch {"token" (B,1), "pos" (B,) int32}.
        Returns (logits (B,1,V_pad), caches)."""
        return self._chain(self.one_stage(params, caches), batch["token"],
                           batch["pos"], paged, "decode"), caches

    def decode_steps(self, stages, batch, paged=None, *, k: int):
        """K fused greedy decode steps on the device (the serving hot
        loop) through the stage chain ``stages`` (:meth:`one_stage` for a
        monolithic engine, a pipelined engine's core stages otherwise): a
        Python loop of ``k`` iterations in which argmax over the logical
        vocab, token feedback, per-row ``pos`` bumps and done masking all
        stay on the device — nothing here synchronises with the host.
        ``paged`` (the ledger's meta) selects the paged pools; ``None``
        the dense caches.  batch: ``token`` (B,1), ``pos`` (B,) and
        ``budget`` (B,) int32, as in the reference.  Returns tokens
        (B,k) int32, the caches written in place; row r's valid prefix
        is its first ``budget[r]`` entries, the rest are -1.
        """
        vocab = self.cfg.vocab_size
        tok, pos, budget = batch["token"], batch["pos"], batch["budget"]
        emits = []
        for _ in range(k):
            tok, pos, budget, emit = greedy_scan_update(
                self._chain(stages, tok, pos, paged, "decode"), pos, budget,
                vocab)
            emits.append(emit)
        return torch.stack(emits, dim=1)

    def verify_steps(self, stages, batch, paged=None):
        """Teacher-forced verification of K draft tokens per row in one
        chunk-mode forward through the stage chain ``stages`` (the
        reference's ``verify_steps``, op for op): the (B, S) chunk
        ``[t0, d0..d_{S-2}]`` (each row's next decode input, then its
        K = S - 1 drafts) runs through the stacks at positions
        ``pos .. pos + S - 1``, writing KV where sequential decode would,
        and :func:`greedy_verify_update` turns the logits into each row's
        emitted tokens.  Nothing here synchronises with the host: ``pos``
        stays on the device, where the batched chunk attention reads it.
        KV written above a row's accepted length is stale by position
        (masked, and overwritten by the next round).

        batch: ``token`` (B, S), ``pos`` (B,) (position of
        ``token[:, 0]``) and ``budget`` (B,) int32 (0 masks the row).
        ``paged`` (the ledger's meta) selects the paged pools, ``None``
        the dense caches; writes past a row's covered blocks land in the
        scratch block.  Returns emit (B, S) int32, -1 in non-emitted
        slots, the caches written in place.
        """
        logits = self._chain(stages, batch["token"], batch["pos"], paged,
                             "chunk")
        return greedy_verify_update(logits, batch["token"], batch["budget"],
                                    self.cfg.vocab_size)


def row_views(caches, segs, row: int, *, paged: bool) -> list:
    """The caches one request's prefill chunk reads and writes: views of
    batch row ``row`` of every dense cache leaf (the reference's
    ``row_isolated``), or, over paged pools (``paged``), of the Mamba
    state rows only (``ssm_row_isolated``; the pools are reached through
    the request's block tables).  Written in place, so every other row
    stays bit-untouched."""
    return [{name: a[:, row:row + 1] for name, a in c.items()}
            if not paged or seg.kind in tfm.MAMBA_KINDS else c
            for seg, c in zip(segs, caches)]


def greedy_scan_update(logits, pos, budget, vocab: int):
    """One macro-step iteration's greedy bookkeeping (the reference's
    ``greedy_scan_update``, op for op).

    Returns (tok (B,1), pos (B,), budget (B,), emit (B,)).  A row's
    last live step emits its sampled token and bumps ``pos``, but the
    *feedback* token is masked by the post-step budget: the host loop
    feeds token 0 for a freed row starting the step AFTER the one that
    finished it, and the masked-row compute stays identical to that."""
    nxt = torch.argmax(logits[:, -1, :vocab], dim=-1).to(torch.int32)
    live = budget > 0
    emit = torch.where(live, nxt, -1)
    budget = budget - live.to(torch.int32)
    tok = torch.where(budget > 0, nxt, 0)[:, None]
    pos = torch.where(live, pos + 1, pos)
    return tok, pos, budget, emit


def greedy_verify_update(logits, tokens, budget, vocab: int):
    """Greedy draft verification (the reference's ``greedy_verify_update``,
    op for op).  ``logits`` (B, S, V_pad) score the fed chunk ``tokens``
    (B, S) = ``[t0, d0..d_{S-2}]``; the greedy target ``g[:, j]``
    predicts position ``pos + j + 1``.  Draft ``d_j`` is accepted iff
    every earlier draft matched and ``g[:, j] == d_j``; the row emits its
    accepted prefix plus ``g`` at the first mismatch (or the bonus token
    after full acceptance), clamped to ``budget``.  Matched drafts are
    the greedy targets, so the emitted prefix is ``g[:, :n_emit]``, with
    -1 in the other slots.  Returns (B, S) int32."""
    g = torch.argmax(logits[:, :, :vocab], dim=-1).to(torch.int32)
    match = (g[:, :-1] == tokens[:, 1:]).to(torch.int32)       # (B,S-1)
    acc = torch.cumprod(match, dim=1).sum(dim=1)                # (B,)
    n_emit = torch.minimum(acc + 1, budget)                     # (B,)
    cols = torch.arange(g.shape[1], dtype=torch.int32,
                        device=g.device)[None, :]
    return torch.where(cols < n_emit[:, None], g, -1)
