"""Deterministic scheduler testbed: the paged engine state machine
with no model, no parameters, and no device work.

:class:`FakeEngine` subclasses :class:`repro_torch.serving.engine.
_PagedEngine`, so admission, block growth, preemption-by-recompute,
macro-step budgeting and the step clock are the *real* scheduler code
— only the three device hooks are replaced:

* ``_reset_row`` / ``_prefill_row`` — host no-ops (the
  :class:`repro_torch.models.kvcache.PagedCache` ledger is pure numpy,
  so block accounting still runs for real, and it never uploads a
  table, so the testbed runs on a machine with no card);
* ``_forward_steps`` — a position-dependent integer recurrence::

      tok' = (31 * tok + 7 * pos + 1) mod 997

  Each step depends only on the previous token and its absolute
  position, so streams are macro-step-K-invariant and survive
  preempt-by-recompute token-identically — exactly the property the
  real greedy decode has, at zero cost.  (``_apply_cow`` stays the
  inherited host no-op for the same reason: the recurrence keeps no
  per-position device state a copy-on-write would have to duplicate,
  while the refcount/COW *ledger* machinery still runs for real —
  the reference's tests/test_prefix_sharing.py drives it through this
  class.)

Every policy decision (EDF ordering, admission-test verdicts, victim
selection, slack aging, virtual-queue drift) is therefore
unit-testable in milliseconds, on the same state machine the port's
engines run on the card.

Speculative decoding runs here too: ``_forward_verify`` scores a
draft chunk against the same recurrence (greedy target per position,
longest matching prefix + correction, budget-clamped — the numpy
mirror of :func:`repro_torch.models.model.greedy_verify_update`), and
:class:`ScriptedDraft` is a schedule-driven provider that proposes
exactly ``a`` correct tokens per round — so acceptance-dependent
scheduler paths (budget clamps, rollback accounting, the EC
spec_accept discount) are unit-testable with *chosen* acceptance
patterns.

The port's copy of ``repro/serving/testbed.py``, held against it by
tests/test_torch_testbed.py: the same streams, stamps and counters
under every policy.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.serving.engine import _PagedEngine

#: recurrence constants — small primes; 997 keeps tokens in-vocab for
#: every smoke config
_A, _B, _C, _MOD = 31, 7, 1, 997


def fake_stream(prompt, n: int) -> list:
    """Reference continuation of ``prompt`` under the testbed
    recurrence — what a request's ``out_tokens`` must equal regardless
    of scheduling (the testbed's golden oracle)."""
    toks = list(prompt)
    out = []
    for _ in range(n):
        pos = len(toks) - 1  # position of the token being fed
        out.append((_A * toks[-1] + _B * pos + _C) % _MOD)
        toks.append(out[-1])
    return out


class ScriptedDraft:
    """Schedule-driven draft provider for the testbed.

    ``schedule[r]`` (cycled; default all-``k``) is how many of the K
    proposals in round ``r`` are *correct* — the true recurrence
    continuation of the row's history — before the provider switches
    to deliberately-wrong tokens (``(true + 1) % _MOD``).  The engine
    must then emit exactly ``min(a, K) + 1`` tokens for an unclamped
    row (accepted prefix + correction/bonus), which makes acceptance
    accounting and rollback arithmetic exactly predictable.  Rounds
    are counted per row, mirroring how providers see one ``propose``
    per live row per verify round.
    """

    def __init__(self, schedule: Optional[Sequence[int]] = None):
        self.schedule = list(schedule) if schedule else None
        self._round: dict = {}

    def propose(self, row: int, history: Sequence[int], k: int) -> list:
        r = self._round.get(row, 0)
        self._round[row] = r + 1
        a = k if self.schedule is None else self.schedule[r % len(
            self.schedule)]
        true = fake_stream(history, k)
        return [t if j < a else (t + 1) % _MOD
                for j, t in enumerate(true)]


class FakeEngine(_PagedEngine):
    """The real paged scheduler over a scripted integer decoder."""

    def __init__(self, cfg=None, *, max_rows: int = 4, max_len: int = 64,
                 block_size: int = 8, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 16, watermark_blocks: int = 0,
                 decode_steps: int = 1, policy=None,
                 prefix_sharing: bool = True, speculative=None):
        cfg = cfg or get_smoke_config("smollm-360m")
        super().__init__(cfg, max_rows=max_rows, max_len=max_len,
                         block_size=block_size, num_blocks=num_blocks,
                         prefill_chunk=prefill_chunk,
                         watermark_blocks=watermark_blocks,
                         decode_steps=decode_steps, policy=policy,
                         prefix_sharing=prefix_sharing,
                         speculative=speculative, device="cpu")

    # ------------------------------------------------------- no devices
    def _reset_row(self, row: int):
        pass

    def _prefill_row(self, row: int, toks: np.ndarray, pos0: int):
        pass

    def _forward_steps(self, tokens: np.ndarray, pos: np.ndarray,
                       budgets: np.ndarray, k: int) -> np.ndarray:
        out = np.zeros((len(tokens), k), dtype=np.int32)
        for i in range(len(tokens)):
            tok, p = int(tokens[i, 0]), int(pos[i])
            for j in range(k):
                tok = (_A * tok + _B * (p + j) + _C) % _MOD
                out[i, j] = tok
        return out

    def _forward_verify(self, tokens: np.ndarray, pos: np.ndarray,
                        budgets: np.ndarray) -> np.ndarray:
        """Numpy mirror of ``Model.verify_steps`` over the testbed
        recurrence: the greedy "target" at chunk slot j is the
        recurrence applied to the *fed* token ``tokens[i, j]``, so the
        accepted length is the longest prefix where drafts reproduce
        the true continuation; emission is the accepted prefix plus
        one correction, clamped to the row budget (-1 padding)."""
        s = tokens.shape[1]
        out = np.full((len(tokens), s), -1, dtype=np.int32)
        for i in range(len(tokens)):
            b = int(budgets[i])
            if b <= 0:
                continue
            p = int(pos[i])
            g = [(_A * int(tokens[i, j]) + _B * (p + j) + _C) % _MOD
                 for j in range(s)]
            acc = 0
            while acc < s - 1 and g[acc] == int(tokens[i, acc + 1]):
                acc += 1
            n = min(acc + 1, b)
            out[i, :n] = g[:n]
        return out
