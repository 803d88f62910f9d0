"""Unified model over paged KV pools: embedding + segments + tied head.

Port of the paged-serving API of ``repro/models/model.py`` for dense
attention decoders::

    m = Model(cfg, device="cuda")
    params = m.init(generator)                                  # or bridge
    hidden, caches = m.paged_prefill_chunk(params, caches, toks, pos0, row, meta)
    logits, caches = m.paged_decode_step(params, caches, batch, meta)
    toks, caches = m.decode_steps(params, caches, batch, meta, k=K)

``caches`` are the pools of :meth:`repro_torch.models.kvcache.PagedCache.
struct`, written **in place** (the returned list is the one passed in);
``meta`` is :meth:`PagedCache.meta`.  Parameters are nested dicts of
tensors in the reference's pytree layout, per-layer weights stacked
along a leading layer dim (``bridge.params_from_numpy`` builds them
from the JAX package's parameters).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import _dense_init, embed, rmsnorm, unembed


class Model:
    def __init__(self, cfg, *, device="cuda"):
        tfm.check_supported(cfg)
        if not cfg.tie_embeddings:
            raise NotImplementedError(f"{cfg.name}: untied LM heads are "
                                      f"not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        self.segments = tfm.build_segments(cfg)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn from ``generator`` (normal times
        fan_in ** -0.5, norms at one, the padded embedding table at
        d_model ** -0.5), in the reference's layout.  The draws differ
        from ``jax.random``'s; to run the reference's weights, bridge
        them instead."""
        cfg = self.cfg
        return {
            "embed": {"w": _dense_init(generator,
                                       (cfg.vocab_padded, cfg.d_model),
                                       self.dtype, self.device,
                                       scale=cfg.d_model ** -0.5)},
            "blocks": tfm.init_segments(generator, cfg, self.dtype,
                                        self.device),
            "final_norm": {"scale": torch.ones(cfg.d_model, dtype=self.dtype,
                                               device=self.device)},
        }

    def _head(self, params, x):
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return unembed(params["embed"], x)  # vocab dim is padded

    def _run(self, params, caches, tokens, pos, paged, mode):
        x = embed(params["embed"], tokens).to(self.dtype)
        return tfm.apply_segments(params["blocks"], x, cfg=self.cfg,
                                  mode=mode, segs=self.segments, pos=pos,
                                  caches=caches, paged=paged)

    # ------------------------------------------------------------------
    def paged_prefill_chunk(self, params, caches, tokens, pos0: int, row: int,
                            paged):
        """Chunked prefill of one request against the pools.

        tokens: (1, C) at absolute positions pos0..; ``paged`` holds the
        request's row-sliced block tables (``meta(row=row)``), so KV
        writes land only in blocks the row owns (``row`` itself selects
        nothing: attn-only models keep no per-row state).  Returns
        (hidden (1,C,D), caches) — no LM head: admission discards prompt
        logits.
        """
        x = self._run(params, caches, tokens, int(pos0), paged, "chunk")
        return x, caches

    def paged_decode_step(self, params, caches, batch, paged):
        """One decode step: batch {"token" (B,1), "pos" (B,) int32}.
        Returns (logits (B,1,V_pad), caches)."""
        x = self._run(params, caches, batch["token"], batch["pos"], paged,
                      "decode")
        return self._head(params, x), caches

    def decode_steps(self, params, caches, batch, paged, *, k: int):
        """K fused greedy decode steps on the device (the serving hot
        loop): a Python loop of ``k`` iterations in which argmax over the
        logical vocab, token feedback, per-row ``pos`` bumps and done
        masking all stay on the device — nothing here synchronises with
        the host.  batch: ``token`` (B,1), ``pos`` (B,) and ``budget``
        (B,) int32, as in the reference.  Returns (tokens (B,k) int32,
        caches); row r's valid prefix is its first ``budget[r]`` entries,
        the rest are -1.
        """
        vocab = self.cfg.vocab_size
        tok, pos, budget = batch["token"], batch["pos"], batch["budget"]
        emits = []
        for _ in range(k):
            logits, caches = self.paged_decode_step(
                params, caches, {"token": tok, "pos": pos}, paged)
            tok, pos, budget, emit = greedy_scan_update(logits, pos, budget,
                                                        vocab)
            emits.append(emit)
        return torch.stack(emits, dim=1), caches


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
