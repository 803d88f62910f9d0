"""Draft-verify speculative decoding for the serving engines.

Port of ``repro/serving/speculative.py``.  Decode reads every weight once
per emitted token; speculation breaks that coupling.  A cheap *draft*
proposes K tokens per row, and the target model scores all of them in
one teacher-forced chunk forward (``Model.verify_steps``), accepting
the longest exactly-matching greedy prefix plus one correction or bonus
token.  Greedy verification is exact: the emitted stream equals plain
greedy decode for any draft, any K and any acceptance pattern; the
drafts change only how many weight reads the stream costs.  It is the
paper's "agile light service assists heavyweight core service"
asymmetry applied to the token loop.

Two draft providers:

:class:`NgramDraft`
    Host-side, model-free n-gram lookup over the request's own history:
    match the longest recent n-gram suffix and propose what followed it
    last time.
:class:`ModelDraft`
    A second, smaller model of the port proposing K greedy tokens
    against its own dense cache on the engine's device.  Rollback and
    preemption-resume truncate the draft's record of what its cache
    holds to the target history's common prefix; stale KV above that
    point is masked by position, which is why the draft config must
    itself pass :func:`spec_supported`.

:func:`spec_supported` admits pure-attention decoder-only configs: SSM
state cannot be rolled back by position, and MoE chunk verification
routes all K + 1 positions through expert capacity at once.  The
engines gate ``speculative=`` off on the others and decode as usual.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.models.transformer import build_segments


def spec_supported(cfg) -> bool:
    """Can ``cfg`` run draft-verify speculative decoding?  Every segment
    full attention (``swa`` with a zero window counts as full), no
    encoder-decoder, no MoE."""
    if getattr(cfg, "is_encoder_decoder", False):
        return False
    if getattr(cfg, "mlp_kind", "dense") == "moe":
        return False
    for seg in build_segments(cfg):
        if seg.kind == "attn":
            continue
        if seg.kind == "swa" and not cfg.window:
            continue
        return False
    return True


class NgramDraft:
    """Self-drafting n-gram proposer (host side, model-free).

    ``propose`` finds the longest (up to ``n``) suffix of the history that
    occurred earlier and proposes the token that followed its most recent
    earlier occurrence; each proposal joins the working history before
    the next.  With no match it repeats the last token."""

    def __init__(self, n: int = 3):
        self.n = max(1, int(n))

    def propose(self, row: int, history: Sequence[int],
                k: int) -> List[int]:
        hist = list(history)
        out: List[int] = []
        for _ in range(k):
            out.append(self._next(hist))
            hist.append(out[-1])
        return out

    def _next(self, hist: List[int]) -> int:
        if not hist:
            return 0
        for n in range(min(self.n, len(hist) - 1), 0, -1):
            suf = hist[-n:]
            for s in range(len(hist) - n - 1, -1, -1):
                if hist[s:s + n] == suf:
                    return hist[s + n]
        return hist[-1]


class ModelDraft:
    """A second, smaller model proposes K greedy tokens per row.

    The draft keeps one dense cache row per engine row on ``device`` and
    a host-side record ``_fed[row]`` of the tokens whose KV that row
    holds.  Each ``propose`` truncates the record to the target
    history's longest common prefix, teacher-forces the new history tail
    through ``Model.prefill_chunk`` in pieces of ``chunk_sizes(..., 16)``,
    then runs ``Model.decode_steps(k=K)`` for the proposals: one host
    sync per round, counted in :attr:`n_host_syncs`.

    ``cfg``: a config, a smoke-config name, or None for the port's smoke
    smollm-360m.  ``params``: the draft's parameters, or None to draw
    them from a CPU :class:`torch.Generator` seeded with ``seed`` (so the
    card and the CPU draw the same weights).  ``device``: where the draft
    runs; None takes the engine's (the engine sets it), else ``"cuda"``.
    """

    #: prefill chunking of teacher-forced history tails
    PREFILL_CHUNK = 16

    def __init__(self, cfg: Any = None, params: Any = None, *,
                 seed: int = 0, cache_len: int = 256, device=None):
        self.cfg = cfg
        self.params = params
        self.seed = seed
        self.cache_len = cache_len
        self.device = device
        self.model: Optional[Model] = None
        self.caches = None
        self._fed: List[List[int]] = []
        self._pos: Optional[np.ndarray] = None
        self.n_host_syncs = 0

    def _ensure(self, rows: int, length: int):
        """(Re)allocate the draft cache to cover ``rows`` rows and
        ``length`` positions; growth resets the record (rows re-prefill
        on their next propose)."""
        if self.model is None:
            cfg = self.cfg
            if cfg is None or isinstance(cfg, str):
                cfg = get_smoke_config(cfg or "smollm-360m")
            if not spec_supported(cfg):
                raise ValueError(
                    "draft config must be a pure-attention decoder-only "
                    "arch (spec_supported): its cache rollback is a "
                    "position truncation")
            self.cfg = cfg
            self.model = Model(cfg, device=self.device or "cuda")
            if self.params is None:
                self.params = self.model.init(
                    torch.Generator().manual_seed(self.seed))
        if (self.caches is None or rows > len(self._fed)
                or length > self.cache_len):
            while self.cache_len < length:
                self.cache_len *= 2
            rows = max(rows, len(self._fed))
            self.caches = self.model.init_cache(rows, self.cache_len)
            self._fed = [[] for _ in range(rows)]
            self._pos = np.zeros(rows, dtype=np.int32)

    def propose(self, row: int, history: Sequence[int],
                k: int) -> List[int]:
        from repro_torch.serving.engine import chunk_sizes

        history = list(history)
        self._ensure(row + 1, len(history) + k + 1)
        dev = self.model.device
        fed = self._fed[row]
        common = 0
        for a, b in zip(fed, history):
            if a != b:
                break
            common += 1
        # teacher-force the unseen history tail (all but the last token,
        # which seeds the proposal steps)
        delta = history[common:-1]
        i = 0
        for c in chunk_sizes(len(delta), self.PREFILL_CHUNK):
            toks = torch.tensor([delta[i:i + c]], dtype=torch.int32,
                                device=dev)
            self.model.prefill_chunk(self.params, self.caches, toks,
                                     common + i, row)
            i += c
        pos = self._pos
        pos[:] = [len(f) for f in self._fed]
        pos[row] = len(history) - 1
        tokens = np.zeros((len(self._fed), 1), dtype=np.int32)
        tokens[row, 0] = history[-1]
        budgets = np.zeros(len(self._fed), dtype=np.int32)
        budgets[row] = k
        batch = {name: torch.from_numpy(a.copy()).to(dev)
                 for name, a in (("token", tokens), ("pos", pos),
                                 ("budget", budgets))}
        toks = self.model.decode_steps(
            self.model.one_stage(self.params, self.caches), batch, k=k)
        # the draft's one host sync a round (counted in n_host_syncs)
        out = [int(t) for t in toks[row].cpu().tolist()]
        self.n_host_syncs += 1
        # the steps fed history[-1], then their own first k - 1 proposals
        self._fed[row] = history + out[:-1]
        return out


@dataclass
class SpecConfig:
    """Speculative-decoding settings (the engines' ``speculative=``).

    ``k``: drafts per row per verify round; a round emits 1 to ``k + 1``
    tokens per live row.  ``draft`` / ``ngram`` / ``draft_cfg``: the
    provider, ``"ngram"`` (n-gram order ``ngram``) or ``"model"`` (a
    :class:`ModelDraft` over ``draft_cfg``, seeded with ``seed``).
    ``provider``: a ready provider (anything with ``propose(row,
    history, k) -> list[int]``), which overrides ``draft``.

    :meth:`make` takes ``None``/``False`` (off), ``True``, an int K, a
    dict of these fields, a provider or a SpecConfig, and returns a fresh
    config with a fresh provider unless one was given: providers hold
    per-row state, so engines never share one."""

    k: int = 4
    draft: str = "ngram"
    ngram: int = 3
    draft_cfg: Any = None
    provider: Any = None
    seed: int = 0

    @staticmethod
    def make(spec) -> Optional["SpecConfig"]:
        if spec is None or spec is False:
            return None
        if spec is True:
            cfg = SpecConfig()
        elif isinstance(spec, SpecConfig):
            cfg = dataclasses.replace(spec)
        elif isinstance(spec, int):
            cfg = SpecConfig(k=spec)
        elif isinstance(spec, dict):
            cfg = SpecConfig(**spec)
        elif hasattr(spec, "propose"):
            cfg = SpecConfig(provider=spec)
        else:
            raise ValueError(
                f"speculative= takes None/bool/int K/dict/SpecConfig/"
                f"draft provider, got {spec!r}")
        if cfg.k < 1:
            raise ValueError(f"speculative draft length k must be >= 1, "
                             f"got {cfg.k}")
        if cfg.provider is None:
            if cfg.draft == "model":
                cfg.provider = ModelDraft(cfg.draft_cfg, seed=cfg.seed)
            elif cfg.draft == "ngram":
                cfg.provider = NgramDraft(n=cfg.ngram)
            else:
                raise ValueError(f"unknown draft kind {cfg.draft!r}; "
                                 f"known: 'ngram', 'model'")
        return cfg
