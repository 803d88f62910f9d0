"""Serving engines: dense slot-based and paged continuous batching.

Port of ``repro/serving/engine.py``'s monolithic engines: the request
model, the queue and step-clock machinery (:class:`_EngineBase`), the
slot state machine (:class:`_SlotEngine`) and :class:`ServingEngine`
over dense caches, and the continuous scheduler over the block ledger
(:class:`_PagedEngine`) and :class:`PagedServingEngine` over paged
pools.  The host-side logic is the reference's, line for line, so
admission (the slot engine's cache-headroom rejection included), block
growth, preemption-by-recompute, copy-on-write prefix sharing,
macro-step sizing and the ``t_*`` stamps match it exactly.  Both engines
take ``quantization=`` ("int8" / "int4", see ``models/quantize.py``) and
pack the projection weights once at construction, and ``speculative=``
(draft-verify speculative decoding, ``serving/speculative.py``): each
engine iteration is then one verify round, in which every live row's
next input and K drafts run through ``Model.verify_steps`` as one chunk
of K + 1 tokens, and the row advances by its accepted length plus one.
It is gated off, as in the reference, on models whose state cannot be
rolled back by position (Mamba), on cross-attention and encoder-decoder
models and on mixtures of experts, which then decode as usual.  Requests
carry no frontend: a cross-attention model's cross K/V (a slot's rows,
or a request's cross blocks) are zeroed at admission, so its cross
layers add exactly zero, as the reference's engines do.

The decode hot loop is device-resident: every engine iteration runs one
macro-step of up to ``decode_steps`` (K) greedy decode iterations
(``Model.decode_steps``) with argmax, token feedback, ``pos`` bumps and
done masking on the device, and synchronises with the host **once** per
macro-step, when it reads the ``(rows, K)`` token ids back (once per
verify round under speculation).  The KV
pools and SSM state rows are updated in place by every call (the
reference donates them instead).

Engine time is a **step counter** (one decode iteration), as in the
reference: ``Request.t_submit`` / ``t_admit`` / ``t_first`` / ``t_done``
are stamped in those units.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.kvcache import (PagedCache, paged_copy_blocks,
                                        paged_reset_row)
from repro_torch.models.model import Model
from repro_torch.models.quantize import quantize_params
from repro_torch.serving.scheduler import (DEFER, REJECT, CapacityView,
                                           make_policy)
from repro_torch.serving.speculative import (ModelDraft, SpecConfig,
                                             spec_supported)


def chunk_sizes(n: int, chunk: int) -> List[int]:
    """Split a prefill of n tokens into full ``chunk``-sized pieces,
    then a power-of-two decomposition of the remainder (the reference's
    chunking, kept so both engines prefill in the same pieces)."""
    out = [chunk] * (n // chunk)
    rem, bit = n % chunk, 1
    tail: List[int] = []
    while rem:
        if rem & 1:
            tail.append(bit)
        bit <<= 1
        rem >>= 1
    return out + tail[::-1]


def reset_cache_row(caches, slot: int):
    """Zero batch row ``slot`` of every dense cache leaf (leaves are
    (n_layers, batch, ...)), in place."""
    for c in caches:
        for a in c.values():
            a[:, slot] = 0
    return caches


@dataclass
class Request:
    """One generation request.  ``t_*`` are engine step-counter stamps:
    ``t_submit`` on submit (kept on resubmission), ``t_admit`` on first
    admission, ``t_first`` at the device step that produced the first
    output token, ``t_done`` on completion or rejection.  ``error`` is
    set instead of raising when the request can never fit."""
    id: int
    prompt: List[int]
    max_new_tokens: int = 16
    qos: str = "standard"
    out_tokens: List[int] = field(default_factory=list)
    t_submit: Optional[int] = None
    t_admit: Optional[int] = None
    t_first: Optional[int] = None
    t_done: Optional[int] = None
    n_preempted: int = 0
    error: Optional[str] = None

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens


class _EngineBase:
    """Queue + step-clock machinery: submission/rejection bookkeeping,
    macro-step sizing, and the run loop.  Subclasses own admission and
    the request store and implement ``step`` / ``_idle`` /
    ``_in_flight`` and the forward hooks."""

    MAX_STEPS = 512

    def __init__(self, cfg, *, prefill_chunk: int, decode_steps: int = 1,
                 policy=None, speculative=None):
        self.cfg = cfg
        self.prefill_chunk = max(1, prefill_chunk)
        self.decode_k = max(1, decode_steps)  # macro-step K
        self.policy = make_policy(policy)
        # draft-verify speculative decoding, gated off on archs whose
        # cache cannot roll back by position (SSM), as in the reference
        self.spec = SpecConfig.make(speculative)
        self.spec_gated_off = (self.spec is not None
                               and not spec_supported(cfg))
        if self.spec_gated_off:
            self.spec = None
        self.spec_rounds = 0     # verify rounds run
        self.spec_drafted = 0    # draft tokens proposed (live rows)
        self.spec_accepted = 0   # draft tokens emitted as matches
        self.spec_emitted = 0    # tokens emitted by verify rounds
        self._spec_row_rounds = 0  # live (row, round) pairs
        self.queue: List[Request] = []
        self.rejected: List[Request] = []
        self.unfinished: List[Request] = []  # in flight at last run() exit
        self.tokens_generated = 0
        self.t = 0  # step counter (the engine clock for Request.t_*)
        self.n_host_syncs = 0      # device->host materializations (decode)
        self.max_macro_tokens = 0  # most tokens emitted by one macro-step
        self.prefill_tokens = 0    # tokens actually prefilled

    def submit(self, req: Request):
        if req.t_submit is None:  # resubmission keeps the original stamp
            req.t_submit = self.t
        self.queue.append(req)
        self.policy.on_submit(req, self.t)

    def _reject(self, req: Request, msg: str):
        """Fail one request without killing the engine."""
        req.error = msg
        req.t_done = self.t
        self.rejected.append(req)

    def _prefill_chunks(self, row: int, toks: List[int], pos0: int = 0):
        """Chunked prefill of one admitted request through the
        ``_prefill_row`` hook; ``pos0`` skips a prefix-cache hit."""
        i = 0
        for c in chunk_sizes(len(toks), self.prefill_chunk):
            self._prefill_row(row, np.asarray(toks[i:i + c],
                                              dtype=np.int32), pos0 + i)
            i += c
        self.prefill_tokens += len(toks)

    def _next_tokens(self, width: int, active: List[int],
                     store: List[Optional[Request]]) -> np.ndarray:
        """Next decode input per active request: last prompt token
        before any generation, else its latest output token."""
        tokens = np.zeros((width, 1), dtype=np.int32)
        for i in active:
            req = store[i]
            tokens[i, 0] = (req.prompt[-1] if not req.out_tokens
                            else req.out_tokens[-1])
        return tokens

    def _k_eff(self, kmax: int) -> int:
        """Scan length for this macro-step: the smallest power of two
        >= the largest row budget, capped at ``decode_k`` (the
        reference's sizing, which decides the engine clock)."""
        k = 1
        while k < kmax and k * 2 <= self.decode_k:
            k *= 2
        return k if k >= kmax else self.decode_k

    def _macro_tail(self, store, budgets: np.ndarray, active: List[int],
                    max_len: int, t0: int,
                    k_cap: Optional[int] = None) -> List[tuple]:
        """Run one fused macro-step and do the host-side bookkeeping:
        slice each row's valid token prefix (its budget), bump ``pos``,
        stamp finishers at the device step they actually completed.
        Returns finished ``(row, request)`` pairs."""
        k_eff = self._k_eff(int(budgets.max()))
        if k_cap is not None and k_eff > k_cap:
            k_eff = 1 << (k_cap.bit_length() - 1)  # largest pow2 <= cap
            budgets = np.minimum(budgets, k_eff)
        tokens = self._next_tokens(len(store), active, store)
        out = self._forward_steps(tokens, self.pos.copy(), budgets, k_eff)
        self.n_host_syncs += 1
        self.max_macro_tokens = max(self.max_macro_tokens,
                                    int(budgets.sum()))
        finished = []
        for i in active:
            req = store[i]
            v = int(budgets[i])
            if v > 0 and req.t_first is None and not req.out_tokens:
                req.t_first = t0 + 1  # first token lands on device step 1
            req.out_tokens += [int(t) for t in out[i, :v]]
            self.tokens_generated += v
            self.pos[i] += v
            if req.done or self.pos[i] >= max_len - 1:
                req.t_done = t0 + v
                finished.append((i, req))
                self.policy.on_done(req, t0 + v)
        self.t = t0 + k_eff
        return finished

    # ------------------------------------------------------------------
    # draft-verify speculative decoding (serving/speculative.py)
    # ------------------------------------------------------------------
    @property
    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens emitted as exact matches."""
        return self.spec_accepted / max(1, self.spec_drafted)

    def spec_accept_mean(self) -> float:
        """Tokens emitted per live row per verify round (accepted length
        + 1), the speculative speedup an admission test sees
        (``CapacityView.spec_accept``); 1.0 before any round."""
        if self._spec_row_rounds == 0:
            return 1.0
        return self.spec_emitted / self._spec_row_rounds

    def _spec_tail(self, store, budgets: np.ndarray, active: List[int],
                   max_len: int, t0: int) -> List[tuple]:
        """Run one draft-verify round and its host-side bookkeeping (the
        reference's ``_spec_tail``, line for line): each live row
        proposes K drafts, ``_forward_verify`` scores them in one chunk
        forward, and the row advances by its accepted length + 1,
        clamped to its budget.  Rollback of rejected drafts is purely
        positional (``self.pos`` advances past emitted tokens only).  One
        round is one engine clock step and one host sync."""
        K = self.spec.k
        width = len(store)
        tokens = np.zeros((width, K + 1), dtype=np.int32)
        tokens[:, :1] = self._next_tokens(width, active, store)
        for i in active:
            req = store[i]
            tokens[i, 1:] = self.spec.provider.propose(
                i, req.prompt + req.out_tokens, K)
            self.spec_drafted += K
        out = self._forward_verify(tokens, self.pos.copy(), budgets)
        self.n_host_syncs += 1
        self.max_macro_tokens = max(self.max_macro_tokens,
                                    int(budgets.sum()))
        self.spec_rounds += 1
        finished = []
        for i in active:
            req = store[i]
            row = out[i]
            v = int((row >= 0).sum())  # accepted length + 1, <= budget
            if v > 0 and req.t_first is None and not req.out_tokens:
                req.t_first = t0 + 1  # the round is one device step
            emitted = [int(t) for t in row[:v]]
            # matched drafts ARE the emitted tokens; the correction token
            # differs from its draft by construction
            self.spec_accepted += sum(
                1 for j in range(min(v, K))
                if emitted[j] == int(tokens[i, 1 + j]))
            self.spec_emitted += v
            self._spec_row_rounds += 1
            req.out_tokens += emitted
            self.tokens_generated += v
            self.pos[i] += v
            if req.done or self.pos[i] >= max_len - 1:
                req.t_done = t0 + 1
                finished.append((i, req))
                self.policy.on_done(req, t0 + 1)
        self.t = t0 + 1
        return finished

    def step(self, k_cap: Optional[int] = None) -> List[Request]:
        raise NotImplementedError  # pragma: no cover - interface

    def _idle(self) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def _in_flight(self) -> List[Request]:  # pragma: no cover - interface
        raise NotImplementedError

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drive the engine until drained or ``max_steps`` decode steps
        have executed.  Requests still in flight when the budget runs
        out are surfaced in :attr:`unfinished` and resume on a further
        ``run()``."""
        max_steps = self.MAX_STEPS if max_steps is None else max_steps
        done = []
        t_end = self.t + max_steps
        while self.t < t_end:
            done += self.step(k_cap=t_end - self.t)
            if not self.queue and self._idle():
                break
        self.unfinished = self._in_flight() + list(self.queue)
        return done

    def _prefill_row(self, row: int, toks: np.ndarray, pos0: int):
        raise NotImplementedError  # pragma: no cover - interface

    def _forward_steps(self, tokens: np.ndarray, pos: np.ndarray,
                       budgets: np.ndarray, k: int) -> np.ndarray:
        """One fused macro-step of ``k`` device decode iterations.
        Returns (rows, k) int32 token ids (row r valid to budgets[r])."""
        raise NotImplementedError  # pragma: no cover - interface

    def _forward_verify(self, tokens: np.ndarray, pos: np.ndarray,
                        budgets: np.ndarray) -> np.ndarray:
        """One draft-verify round over the (rows, K+1) chunk ``[next
        input, K drafts]``.  Returns (rows, K+1) int32 emitted tokens, -1
        in non-emitted slots."""
        raise NotImplementedError  # pragma: no cover - interface


class _SlotEngine(_EngineBase):
    """Slot state machine: admission (chunked prefill), fused macro-step
    greedy decode, finish bookkeeping.  A request is admitted only when a
    whole slot (one ``cache_len`` cache row) is free.  Forward passes are
    delegated to the subclass hooks ``_reset_row(slot)``,
    ``_prefill_row(slot, toks, pos0)`` and ``_forward_steps``."""

    def __init__(self, cfg, *, max_batch: int, cache_len: int,
                 prefill_chunk: int, decode_steps: int = 1, policy=None,
                 speculative=None):
        super().__init__(cfg, prefill_chunk=prefill_chunk,
                         decode_steps=decode_steps, policy=policy,
                         speculative=speculative)
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.pos = np.zeros(max_batch, dtype=np.int32)
        self.slots: List[Optional[Request]] = [None] * max_batch

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _idle(self) -> bool:
        return all(s is None for s in self.slots)

    def _in_flight(self) -> List[Request]:
        return [s for s in self.slots if s is not None]

    def _capacity_view(self, free_slots: int) -> CapacityView:
        """Dense capacity in policy units: one slot = one full
        ``cache_len`` granule."""
        return CapacityView(free_tokens=free_slots * self.cache_len,
                            total_tokens=self.max_batch * self.cache_len,
                            granule=self.cache_len,
                            spec_accept=self.spec_accept_mean())

    def _admit(self):
        """Prefill queued requests into free slots, ``prefill_chunk``
        prompt tokens per call (the final prompt token is the first
        decode input).  The policy chooses which queued request is tried
        next and may reject it; a deferred choice blocks admission."""
        free = self._free_slots()
        while free and self.queue:
            req = self.policy.next_admission(self.queue, self.t)
            if req is None:
                break
            # admission must leave max_new_tokens of cache headroom: the
            # decode loop stops a slot at pos >= cache_len - 1
            if len(req.prompt) + req.max_new_tokens > self.cache_len:
                self.queue.remove(req)
                self._reject(
                    req, f"prompt of {len(req.prompt)} + max_new_tokens "
                         f"{req.max_new_tokens} exceeds cache_len "
                         f"{self.cache_len}")
                continue
            verdict, msg = self.policy.admission_test(
                req, self.t, self._capacity_view(len(free)))
            if verdict == REJECT:
                self.queue.remove(req)
                self._reject(req, msg or "rejected by admission test")
                continue
            if verdict == DEFER:
                break
            slot = free.pop(0)
            self.queue.remove(req)
            if req.t_admit is None:
                req.t_admit = self.t
            self.slots[slot] = req
            self._reset_row(slot)
            toks = req.prompt[:-1]
            self._prefill_chunks(slot, toks)
            self.pos[slot] = len(toks)

    def step(self, k_cap: Optional[int] = None) -> List[Request]:
        """One engine iteration: admit + one fused macro-step of up to
        ``decode_k`` batched decode iterations (``k_cap`` further bounds
        the device steps).  Returns finished requests."""
        t0 = self.t
        self.t += 1  # admission/rejection stamps land on the first step
        self.policy.on_step(self.t, self.queue, self._in_flight())
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        # a verify round emits up to K+1 tokens per row in one engine
        # step, so its budget counts tokens, not scan steps
        k = (self.spec.k + 1 if self.spec is not None
             else self.decode_k if k_cap is None
             else max(1, min(self.decode_k, k_cap)))
        # per-row step budget: never decode past max_new_tokens or the
        # cache-headroom stop (pos >= cache_len - 1) inside the macro-step
        budgets = np.zeros(self.max_batch, dtype=np.int32)
        for i in active:
            req = self.slots[i]
            budgets[i] = max(1, min(
                k, req.max_new_tokens - len(req.out_tokens),
                self.cache_len - 1 - int(self.pos[i])))
        if self.spec is not None:
            finished = self._spec_tail(self.slots, budgets, active,
                                       self.cache_len, t0)
        else:
            finished = self._macro_tail(self.slots, budgets, active,
                                        self.cache_len, t0, k_cap=k_cap)
        done = []
        for i, req in finished:
            self.slots[i] = None
            self.policy.on_free(1, self.t)  # one slot granule returned
            done.append(req)
        return done

    def _reset_row(self, slot: int):  # pragma: no cover - interface
        raise NotImplementedError


class _PagedEngine(_EngineBase):
    """Continuous-batching scheduler over a paged KV cache: every step
    admits queued requests while the block pool has room (token-level
    admission), grows running requests block by block, and resolves
    pool exhaustion by preempting the most recently admitted request
    (recompute on re-admission keeps greedy outputs token-identical).
    Subclasses supply ``_reset_row`` (zero a row's per-request state at
    admission: SSM state and cross blocks; attn pools need none, stale
    KV is position-masked), ``_prefill_row``,
    ``_forward_steps`` and ``_apply_cow``."""

    MAX_STEPS = 4096  # preemption churn can stretch a busy run

    def __init__(self, cfg, *, max_rows: int, max_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 16, watermark_blocks: int = 0,
                 decode_steps: int = 1, policy=None,
                 prefix_sharing: bool = True, speculative=None,
                 device="cuda"):
        super().__init__(cfg, prefill_chunk=prefill_chunk,
                         decode_steps=decode_steps, policy=policy,
                         speculative=speculative)
        self.max_rows = max_rows
        self.max_len = max_len
        self.pc = PagedCache(cfg, max_rows=max_rows, max_len=max_len,
                             block_size=block_size, num_blocks=num_blocks,
                             watermark_blocks=watermark_blocks,
                             share_prefixes=prefix_sharing, device=device)
        self.pos = np.zeros(max_rows, dtype=np.int32)
        self.rows: List[Optional[Request]] = [None] * max_rows
        self._admit_order: List[int] = []   # rows, oldest admission first
        self.n_preemptions = 0

    def _free_rows(self) -> List[int]:
        return [i for i, r in enumerate(self.rows) if r is None]

    def _idle(self) -> bool:
        return all(r is None for r in self.rows)

    def _in_flight(self) -> List[Request]:
        return [r for r in self.rows if r is not None]

    def _capacity_view(self) -> CapacityView:
        bs = self.pc.block_size
        return CapacityView(free_tokens=self.pc.free_blocks * bs,
                            total_tokens=self.pc.num_blocks * bs,
                            granule=bs,
                            shared_blocks=self.pc.probe_hit,
                            spec_accept=self.spec_accept_mean())

    def _admit(self):
        """Token-level admission in the policy's head-of-line order: a
        request is admitted whenever a decode row is free and the pool
        holds its blocks (prompt + already-decoded prefix after a
        preemption); a blocked or deferred choice waits."""
        free = self._free_rows()
        while free and self.queue:
            req = self.policy.next_admission(self.queue, self.t)
            if req is None:
                break
            if (len(req.prompt) + req.max_new_tokens > self.max_len
                    or not self.pc.fits(
                        len(req.prompt) + req.max_new_tokens)):
                self.queue.remove(req)
                self._reject(
                    req, f"prompt of {len(req.prompt)} + max_new_tokens "
                         f"{req.max_new_tokens} exceeds capacity "
                         f"(max_len {self.max_len}, "
                         f"{self.pc.num_blocks} blocks)")
                continue
            verdict, msg = self.policy.admission_test(
                req, self.t, self._capacity_view())
            if verdict == REJECT:
                self.queue.remove(req)
                self._reject(req, msg or "rejected by admission test")
                continue
            total = len(req.prompt) + len(req.out_tokens)
            toks = (req.prompt + req.out_tokens)[:-1]
            wm = (None if any(r is not None for r in self.rows) else 0)
            if verdict == DEFER or not self.pc.can_admit(total,
                                                         watermark=wm,
                                                         tokens=toks):
                break
            self.queue.remove(req)
            row = free.pop(0)
            if not self.pc.admit(row, total, watermark=wm, tokens=toks):
                raise RuntimeError(
                    f"ledger refused admission it just approved "
                    f"(row {row}, {total} tokens)")
            if req.t_admit is None:
                req.t_admit = self.t
            self.rows[row] = req
            self._admit_order.append(row)
            self._reset_row(row)
            # a prefix hit maps the matched span's blocks into the
            # table already filled — prefill only the tail beyond it
            hit = self.pc.hit_tokens(row)
            self._prefill_chunks(row, toks[hit:], pos0=hit)
            self.pos[row] = len(toks)

    def _preempt(self, row: int):
        """Preempt-by-recompute: free the row's blocks and put the
        request back at the head of the queue carrying its generated
        prefix (evicted instead after ``policy.max_preemptions``)."""
        req = self.rows[row]
        self.pc.release(row)
        self.rows[row] = None
        self._admit_order.remove(row)
        self.n_preemptions += 1
        req.n_preempted += 1
        cap = self.policy.max_preemptions
        if cap is not None and req.n_preempted >= cap:
            self._reject(
                req, f"{req.qos}: evicted after {req.n_preempted} "
                     f"preemptions (max_preemptions={cap})")
            return
        self.queue.insert(0, req)
        self.policy.on_preempt(req, self.t)

    def _grow(self, k: int) -> tuple:
        """Block-budgeted macro-step sizing: guarantee every active
        row's next write (preempting newest-admitted rows on pool
        exhaustion), then grow opportunistically up to ``k`` steps of
        coverage.  Returns ``(budgets, clip)``: per-row step budgets and
        the smallest block-clipped budget (None if no row was clipped)."""
        budgets = np.zeros(self.max_rows, dtype=np.int32)
        clip: Optional[int] = None
        for row in list(self._admit_order):
            req = self.rows[row]
            if req is None:
                continue
            pos = int(self.pos[row])
            while not self.pc.ensure(row, pos):
                cands = [(r, self.rows[r]) for r in self._admit_order
                         if self.rows[r] is not None]
                victim = self.policy.select_victim(cands, self.t,
                                                   needy=row)
                if victim is None:
                    victim = row
                self._preempt(victim)
                if victim == row:
                    break
            if self.rows[row] is None:  # preempted itself
                continue
            want = max(1, min(k, req.max_new_tokens - len(req.out_tokens),
                              self.max_len - 1 - pos))
            steps = 1
            while steps < want and self.pc.ensure(row, pos + steps):
                steps += 1
            if steps < want:  # pool-limited: this row must resume
                clip = steps if clip is None else min(clip, steps)
            budgets[row] = steps
        return budgets, clip

    def step(self, k_cap: Optional[int] = None) -> List[Request]:
        """One scheduler iteration: admit + grow/preempt + one fused
        macro-step of up to ``decode_k`` decode iterations (``k_cap``
        further bounds the device steps).  Returns finished requests."""
        t0 = self.t
        self.t += 1  # admission/rejection stamps land on the first step
        self.policy.on_step(self.t, self.queue, self._in_flight())
        self._admit()
        # a verify round's budget counts tokens: _grow covers up to K+1
        # writes per row
        k = (self.spec.k + 1 if self.spec is not None
             else self.decode_k if k_cap is None
             else max(1, min(self.decode_k, k_cap)))
        budgets, clip = self._grow(k)
        # copy-on-write pool copies must hit the device pools before the
        # macro-step reads or writes the fresh copies
        pairs = self.pc.take_pending_copies()
        if pairs:
            self._apply_cow(pairs)
        active = [i for i, r in enumerate(self.rows) if r is not None]
        if not active:
            return []
        if self.spec is not None:
            # clip needs nothing more: emission clamps to the covered
            # budget, verify writes beyond it land in the scratch block
            # (never read below the accepted length), and the SSM-resume
            # hazard clip guards against cannot occur (speculation is
            # gated to pure-attention archs)
            finished = self._spec_tail(self.rows, budgets, active,
                                       self.max_len, t0)
        else:
            caps = [c for c in (clip, k_cap) if c is not None]
            cap = min(caps) if caps else None
            finished = self._macro_tail(self.rows, budgets, active,
                                        self.max_len, t0, k_cap=cap)
        done = []
        for i, req in finished:
            self.rows[i] = None
            self._admit_order.remove(i)
            fb0 = self.pc.free_blocks
            self.pc.release(i)
            self.policy.on_free(self.pc.free_blocks - fb0, self.t)
            done.append(req)
        return done

    def _reset_row(self, row: int):  # pragma: no cover - interface
        raise NotImplementedError

    def _apply_cow(self, pairs: List[tuple]):
        """Apply queued COW pool copies ``[(src, dst), ...]`` to the
        device pools (a no-op for ledgers without pools)."""

    @property
    def active_rows(self) -> int:
        return sum(1 for r in self.rows if r is not None)


def _build_model(engine, cfg, params, seed: int, quantization) -> None:
    """The monolithic engines' shared set-up: the model, its parameters
    (drawn from a generator seeded with ``seed`` unless given) and their
    projection weights packed once to ``quantization``; a model draft
    that names no device runs on the engine's."""
    provider = engine.spec.provider if engine.spec is not None else None
    if isinstance(provider, ModelDraft) and provider.device is None:
        provider.device = engine.device
    engine.model = Model(cfg, qformat=quantization, device=engine.device)
    engine.quantization = engine.model.qformat
    if params is None:
        gen = torch.Generator(device=engine.device).manual_seed(seed)
        params = engine.model.init(gen)
    engine.params = quantize_params(params, engine.quantization)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _batch(tokens: np.ndarray, pos: np.ndarray, budgets: np.ndarray,
           device) -> dict:
    """A macro-step's or verify round's inputs on the device."""
    return {"token": _to_device(tokens, device),
            "pos": _to_device(pos, device),
            "budget": _to_device(budgets, device)}


class ServingEngine(_SlotEngine):
    """The slot engine over the port's model with dense caches
    (``Model.decode_steps(paged=None)`` / ``Model.prefill_chunk``).

    ``params`` are the model's parameters (``bridge.params_from_numpy``
    for the reference's weights); without them the model draws its own
    from a :class:`torch.Generator` seeded with ``seed``.
    ``quantization`` ("int8" / "int4"; None or "bf16" for none) packs
    the projection weights once here.  ``speculative`` (``SpecConfig.make``'s
    forms: an int K, a dict, a provider) turns on draft-verify speculative
    decoding.  ``device`` defaults to ``"cuda"`` and raises without a
    card; ``device="cpu"`` runs the kernels' plain versions.
    """

    def __init__(self, cfg, params=None, *, max_batch: int = 4,
                 cache_len: int = 128, seed: int = 0,
                 prefill_chunk: int = 16, decode_steps: int = 1,
                 policy=None, speculative=None, quantization=None,
                 device="cuda"):
        self.device = resolve_device(device)
        super().__init__(cfg, max_batch=max_batch, cache_len=cache_len,
                         prefill_chunk=prefill_chunk,
                         decode_steps=decode_steps, policy=policy,
                         speculative=speculative)
        _build_model(self, cfg, params, seed, quantization)
        self.caches = self.model.init_cache(max_batch, cache_len)

    def _reset_row(self, slot: int):
        reset_cache_row(self.caches, slot)

    def _prefill_row(self, slot: int, toks: np.ndarray, pos0: int):
        self.model.prefill_chunk(self.params, self.caches,
                                 _to_device(toks[None], self.device), pos0,
                                 slot)

    def _forward_steps(self, tokens: np.ndarray, pos: np.ndarray,
                       budgets: np.ndarray, k: int) -> np.ndarray:
        toks = self.model.decode_steps(
            self.model.one_stage(self.params, self.caches),
            _batch(tokens, pos, budgets, self.device), k=k)
        # reprolint: disable-next=host-sync -- the ONE deliberate sync
        # per macro-step (counted in n_host_syncs; <= 1/K per token)
        return np.asarray(toks.cpu())

    def _forward_verify(self, tokens: np.ndarray, pos: np.ndarray,
                        budgets: np.ndarray) -> np.ndarray:
        emit = self.model.verify_steps(
            self.model.one_stage(self.params, self.caches),
            _batch(tokens, pos, budgets, self.device))
        # reprolint: disable-next=host-sync -- the ONE deliberate sync
        # per verify round (counted in n_host_syncs; <= 1 per token)
        return np.asarray(emit.cpu())


class PagedServingEngine(_PagedEngine):
    """The continuous scheduler over the port's paged model
    (``Model.decode_steps`` / ``Model.paged_prefill_chunk``).  Block
    tables reach the device through ``PagedCache.meta``'s versioned
    snapshot, re-uploaded only when the ledger changed.  Greedy streams
    equal :class:`ServingEngine`'s at equal ``max_len`` / ``cache_len``.

    ``params``, ``seed``, ``quantization``, ``speculative`` and ``device``
    as for :class:`ServingEngine`.
    """

    def __init__(self, cfg, params=None, *, max_rows: int = 8,
                 max_len: int = 128, block_size: int = 16,
                 num_blocks: Optional[int] = None, seed: int = 0,
                 prefill_chunk: int = 16, watermark_blocks: int = 0,
                 decode_steps: int = 1, policy=None,
                 prefix_sharing: bool = True, speculative=None,
                 quantization=None, device="cuda"):
        self.device = resolve_device(device)
        super().__init__(cfg, max_rows=max_rows, max_len=max_len,
                         block_size=block_size, num_blocks=num_blocks,
                         prefill_chunk=prefill_chunk,
                         watermark_blocks=watermark_blocks,
                         decode_steps=decode_steps, policy=policy,
                         prefix_sharing=prefix_sharing,
                         speculative=speculative, device=self.device)
        _build_model(self, cfg, params, seed, quantization)
        self.caches = self.pc.struct(self.model.dtype)

    def _apply_cow(self, pairs):
        src = torch.tensor([s for s, _ in pairs], dtype=torch.long,
                           device=self.device)
        dst = torch.tensor([d for _, d in pairs], dtype=torch.long,
                           device=self.device)
        paged_copy_blocks(self.caches, src, dst, has_swa=self.pc.has_swa)

    def _reset_row(self, row: int):
        paged_reset_row(self.caches, self.model.segments, row,
                        self.pc.cross_ids(row))

    def _prefill_row(self, row: int, toks: np.ndarray, pos0: int):
        self.model.paged_prefill_chunk(
            self.params, self.caches, _to_device(toks[None], self.device),
            pos0, row, self.pc.meta(row=row))

    def _forward_steps(self, tokens: np.ndarray, pos: np.ndarray,
                       budgets: np.ndarray, k: int) -> np.ndarray:
        toks = self.model.decode_steps(
            self.model.one_stage(self.params, self.caches),
            _batch(tokens, pos, budgets, self.device), self.pc.meta(), k=k)
        # reprolint: disable-next=host-sync -- the ONE deliberate sync
        # per macro-step (counted in n_host_syncs; <= 1/K per token)
        return np.asarray(toks.cpu())

    def _forward_verify(self, tokens: np.ndarray, pos: np.ndarray,
                        budgets: np.ndarray) -> np.ndarray:
        emit = self.model.verify_steps(
            self.model.one_stage(self.params, self.caches),
            _batch(tokens, pos, budgets, self.device), self.pc.meta())
        # reprolint: disable-next=host-sync -- the ONE deliberate sync
        # per verify round (counted in n_host_syncs; <= 1 per token)
        return np.asarray(emit.cpu())
