"""Unified model over dense or paged caches: embedding + segments +
head (tied, or an untied ``lm_head``).

Port of the serving API of ``repro/models/model.py`` for attention
decoders and Mamba1 models::

    m = Model(cfg, qformat=None, device="cuda")
    params = m.init(generator)                                  # or bridge
    caches = m.init_cache(batch, cache_len)                     # dense slots
    hidden, caches = m.prefill_chunk(params, caches, toks, pos0, slot)
    logits, caches = m.decode_step(params, caches, batch)
    hidden, caches = m.paged_prefill_chunk(params, pools, toks, pos0, row, meta)
    logits, caches = m.paged_decode_step(params, pools, batch, meta)
    toks, caches = m.decode_steps(params, caches, batch, meta_or_None, k=K)
    emit, caches = m.verify_steps(params, caches, batch, meta_or_None)
    logits, _, aux = m.forward(params, {"tokens": toks}, mode="train")

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
under a checkpoint, gradients through autograd.
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
            "blocks": tfm.init_segments(generator, cfg, self.dtype,
                                        self.device),
            "final_norm": {"scale": torch.ones(cfg.d_model, dtype=self.dtype,
                                               device=self.device)},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = table()
        return params

    def _final_norm(self, params, stream):
        """The final norm of ``_run``'s (x, delta): the last block's
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
        """Logits from ``_run``'s (x, delta) over the padded vocab."""
        return unembed(self._head_params(params),
                       self._final_norm(params, stream))

    def head_weight(self, params) -> torch.Tensor:
        """The LM head's table (V_pad, D): the tied embedding or the
        untied ``lm_head``."""
        return self._head_params(params)["w"]

    def forward(self, params, batch, mode: str = "train",
                return_hidden: bool = False):
        """Train-mode forward over batch {"tokens" (B,S) int}: the
        embedding, every block (each under a checkpoint, the residual add
        fused into the next norm) at positions 0 .. S - 1, the final norm
        and, unless ``return_hidden``, the head over the padded vocab.
        Returns (logits (B,S,V_pad) or hidden (B,S,D), None, aux), aux
        the reference's ``_empty_aux`` for these dense models (zero MoE
        terms).  The reference's ``mode="prefill"`` (a full prompt into
        the caches) is not ported: the engines prefill in chunks."""
        if mode != "train":
            raise NotImplementedError(
                f"Model.forward(mode={mode!r}) is not ported yet; the port "
                f"runs mode='train' (the engines prefill in chunks)")
        tfm.check_supported(self.cfg, mode)
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed(params["embed"], tokens).to(self.dtype)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        stream = tfm.apply_segments(params["blocks"], x, cfg=self.cfg,
                                    mode=mode, segs=self.segments,
                                    positions=positions,
                                    qformat=self.qformat)
        zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
        aux = {"moe_aux_loss": zero, "moe_drop_frac": zero}
        hidden = self._final_norm(params, stream)
        if return_hidden:
            return hidden, None, aux
        return unembed(self._head_params(params), hidden), None, aux

    def _run(self, params, caches, tokens, pos, paged, mode):
        """The stacks over the embedded tokens: (x, delta), the residual
        stream and the last block's output not yet added to it."""
        x = embed(params["embed"], tokens).to(self.dtype)
        return tfm.apply_segments(params["blocks"], x, cfg=self.cfg,
                                  mode=mode, segs=self.segments, pos=pos,
                                  caches=caches, paged=paged,
                                  qformat=self.qformat)

    def _hidden(self, params, caches, tokens, pos, paged):
        """A chunk's hidden state: it has no head, so the last pending
        residual add is one plain add."""
        x, delta = self._run(params, caches, tokens, pos, paged, "chunk")
        return x if delta is None else x + delta

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, dtype=None) -> list:
        """Dense slot caches on the model's device
        (``kvcache.cache_struct``), in the model dtype unless given."""
        return cache_struct(self.cfg, batch, cache_len, dtype or self.dtype,
                            device=self.device)

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
        rows = [{name: a[:, slot:slot + 1] for name, a in c.items()}
                for c in caches]
        return self._hidden(params, rows, tokens, int(pos0), None), caches

    def decode_step(self, params, caches, batch):
        """One decode step against the dense caches: batch {"token"
        (B,1), "pos" (B,) int32}.  Returns (logits (B,1,V_pad), caches)."""
        stream = self._run(params, caches, batch["token"], batch["pos"],
                           None, "decode")
        return self._head(params, stream), caches

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
        rows = [{name: a[:, row:row + 1] for name, a in c.items()}
                if seg.kind == "mamba1" else c
                for seg, c in zip(self.segments, caches)]
        return self._hidden(params, rows, tokens, int(pos0), paged), caches

    def paged_decode_step(self, params, caches, batch, paged):
        """One decode step: batch {"token" (B,1), "pos" (B,) int32}.
        Returns (logits (B,1,V_pad), caches)."""
        stream = self._run(params, caches, batch["token"], batch["pos"],
                           paged, "decode")
        return self._head(params, stream), caches

    def decode_steps(self, params, caches, batch, paged=None, *, k: int):
        """K fused greedy decode steps on the device (the serving hot
        loop): a Python loop of ``k`` iterations in which argmax over the
        logical vocab, token feedback, per-row ``pos`` bumps and done
        masking all stay on the device — nothing here synchronises with
        the host.  ``paged`` (the ledger's meta) selects the paged pools;
        ``None`` the dense caches.  batch: ``token`` (B,1), ``pos`` (B,)
        and ``budget`` (B,) int32, as in the reference.  Returns (tokens
        (B,k) int32, caches); row r's valid prefix is its first
        ``budget[r]`` entries, the rest are -1.
        """
        vocab = self.cfg.vocab_size
        tok, pos, budget = batch["token"], batch["pos"], batch["budget"]
        emits = []
        for _ in range(k):
            stream = self._run(params, caches, tok, pos, paged, "decode")
            tok, pos, budget, emit = greedy_scan_update(
                self._head(params, stream), pos, budget, vocab)
            emits.append(emit)
        return torch.stack(emits, dim=1), caches

    def verify_steps(self, params, caches, batch, paged=None):
        """Teacher-forced verification of K draft tokens per row in one
        chunk-mode forward (the reference's ``verify_steps``, op for op):
        the (B, S) chunk ``[t0, d0..d_{S-2}]`` (each row's next decode
        input, then its K = S - 1 drafts) runs through the stacks at
        positions ``pos .. pos + S - 1``, writing KV where sequential
        decode would, and :func:`greedy_verify_update` turns the logits
        into each row's emitted tokens.  Nothing here synchronises with
        the host: ``pos`` stays on the device, where the batched chunk
        attention reads it.  KV written above a row's accepted length is
        stale by position (masked, and overwritten by the next round).

        batch: ``token`` (B, S), ``pos`` (B,) (position of
        ``token[:, 0]``) and ``budget`` (B,) int32 (0 masks the row).
        ``paged`` (the ledger's meta) selects the paged pools, ``None``
        the dense caches; writes past a row's covered blocks land in the
        scratch block.  Returns (emit (B, S) int32, -1 in non-emitted
        slots; caches).
        """
        stream = self._run(params, caches, batch["token"], batch["pos"],
                           paged, "chunk")
        emit = greedy_verify_update(self._head(params, stream),
                                    batch["token"], batch["budget"],
                                    self.cfg.vocab_size)
        return emit, caches


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
