"""Dispatch counting for the serving engines' device calls.

The hot-loop contract (SERVING.md §The decode hot loop) is quantitative:
steady-state decode must cost at most ``1/K`` device dispatches and
host syncs per generated token.  That claim rots silently: a stray host
read or an un-fused call re-introduces per-token overhead without
failing any parity test.  This module makes it testable.

The reference counts the jitted programs each engine keeps in a
``_jits`` dict.  The port compiles no programs: its engines run eager
forwards through a handful of device hooks.  :func:`instrument` wraps
those hooks on the instance, without touching engine code, and counts
each call under the name the reference gives the program it stands
for, so the two tallies compare key for key:

============================  ========================================
key                           one call of
============================  ========================================
``decode{k}``                 ``_forward_steps`` with scan length k
``verify{s}``                 ``_forward_verify`` over a chunk of s
``prefill``                   ``_prefill_row`` (one prefill chunk)
``reset``                     ``_reset_row``
``cow``                       ``_apply_cow`` (a paged engine's COW)
``s{i}.prefill`` / ``.reset``  a pipelined engine's stage i hooks
/ ``.cow`` / ``.decode``       (``.decode``: a step of ``profile``)
``draft.draft_fill{c}``       a ModelDraft's prefill chunk of c tokens
``draft.draft_step{k}``       a ModelDraft's proposal steps
============================  ========================================

Beside the dispatches, :attr:`EngineCounts.kernel_launches` holds the
port's own kernel launches since instrumentation (the counters of
``kernels/_build.py``): one dispatch fans out into the launches of
every layer's kernels.  An engine with no model (the testbed's
``FakeEngine``) makes no device call and is not counted, as the
reference's has no jitted program.

    eng = PagedServingEngine(cfg, decode_steps=8)
    counts = instrument(eng)
    ...
    counts.decode_dispatches / eng.tokens_generated   # <= 1/K + prefill

The port's counterpart of ``repro/serving/instrument.py``, held against
it by tests/test_torch_testbed.py: equal counts per key on equal traces.
"""
from __future__ import annotations

from collections import Counter

from repro_torch.kernels import _build


def _wrap(obj, attr: str, counts: Counter, key) -> None:
    """Replace the bound method ``obj.attr`` with one that counts each
    call under ``key(*args, **kwargs)`` (a str or None for no count)."""
    fn = getattr(obj, attr)

    def counted(*args, **kw):
        name = key(*args, **kw)
        if name is not None:
            counts[name] += 1
        return fn(*args, **kw)

    setattr(obj, attr, counted)


class DispatchCounter:
    """Counting wrappers over one engine's (or stage's, or draft's)
    device hooks, each call tallied in ``counts`` under ``prefix`` and the
    reference's program name."""

    def __init__(self, counts: Counter, prefix: str = ""):
        self.counts = counts
        self.prefix = prefix

    def hook(self, obj, attr: str, key) -> None:
        """Count calls of ``obj.attr``; ``key`` is a name or a function of
        the call's arguments returning one."""
        _wrap(obj, attr, self.counts, lambda *a, **kw: self.prefix + (
            key if isinstance(key, str) else key(*a, **kw)))


class EngineCounts:
    """Per-engine dispatch tallies with the derived hot-loop ratios, and
    the kernel launches made since :func:`instrument`."""

    def __init__(self, engine):
        self.engine = engine
        self.counts: Counter = Counter()
        self._launches0 = dict(_build.launches)

    @property
    def kernel_launches(self) -> dict:
        """Launches of each port kernel since instrumentation (every
        engine in the process counts: instrument one at a time)."""
        return {k: n - self._launches0.get(k, 0)
                for k, n in _build.launches.items()}

    @property
    def decode_dispatches(self) -> int:
        return sum(n for name, n in self.counts.items()
                   if name.rsplit(".", 1)[-1].startswith("decode"))

    @property
    def prefill_dispatches(self) -> int:
        return sum(n for name, n in self.counts.items()
                   if name.rsplit(".", 1)[-1] == "prefill")

    @property
    def verify_dispatches(self) -> int:
        """Draft-verify rounds (``verify{K+1}``), deliberately not counted
        as decode dispatches: the hot-loop ratio pins
        ``decode_dispatches`` to the plain macro-step, and a speculative
        engine's analogue is ``verify_dispatches / tokens_generated``
        (between 1 and 1/(K+1))."""
        return sum(n for name, n in self.counts.items()
                   if name.rsplit(".", 1)[-1].startswith("verify"))

    @property
    def draft_dispatches(self) -> int:
        """A ModelDraft's device calls (``draft.*``: its prefill chunks
        and proposal steps; 0 for host-only drafts)."""
        return sum(n for name, n in self.counts.items()
                   if name.startswith("draft."))

    @property
    def total_dispatches(self) -> int:
        return sum(self.counts.values())

    def per_token(self, kind: str = "decode") -> float:
        """Dispatches per generated token (``decode``/``prefill``/
        ``total``)."""
        n = getattr(self, f"{kind}_dispatches")
        return n / max(self.engine.tokens_generated, 1)


def _instrument_draft(provider, counts: Counter) -> None:
    """Count a ModelDraft's calls once its model exists (it is built at
    the first proposal)."""
    dc = DispatchCounter(counts, prefix="draft.")
    ensure = provider._ensure

    def ensured(*args, **kw):
        ensure(*args, **kw)
        model = provider.model
        if not getattr(model, "_instrumented", False):
            dc.hook(model, "prefill_chunk",
                    lambda p, c, toks, *a, **k: f"draft_fill{toks.shape[1]}")
            dc.hook(model, "decode_steps",
                    lambda *a, k=1, **kw: f"draft_step{k}")
            model._instrumented = True

    provider._ensure = ensured


def instrument(engine) -> EngineCounts:
    """Wrap ``engine``'s device hooks (its pipeline stages', and a model
    draft's, if any) with dispatch counters.  Counting starts now:
    tallies cover only calls made after instrumentation."""
    ec = EngineCounts(engine)
    if getattr(engine, "model", None) is None:
        return ec
    dc = DispatchCounter(ec.counts)
    dc.hook(engine, "_forward_steps",
            lambda tokens, pos, budgets, k: f"decode{k}")
    dc.hook(engine, "_forward_verify",
            lambda tokens, pos, budgets: f"verify{tokens.shape[1]}")
    stages = getattr(engine, "stages", None)
    if stages is None:
        dc.hook(engine, "_prefill_row", "prefill")
        dc.hook(engine, "_reset_row", "reset")
        if hasattr(engine, "pc"):
            dc.hook(engine, "_apply_cow", "cow")
    else:
        for i, st in enumerate(stages):
            sc = DispatchCounter(ec.counts, prefix=f"s{i}.")
            sc.hook(st, "prefill", "prefill")
            sc.hook(st, "reset_row", "reset")
            if st.paged is not None:
                sc.hook(st, "copy_blocks", "cow")
        # profile() steps each stage through Model.run_stages directly:
        # count those steps (and only those) as the stage's decode
        by_lo = {st.lo: i for i, st in enumerate(stages)}
        profiling = [False]
        _wrap(engine.model, "run_stages", ec.counts,
              lambda params, x, lo, *a, **kw: (
                  f"s{by_lo[lo]}.decode" if profiling[0] else None))
        profile = engine.profile

        def counted_profile(*args, **kw):
            profiling[0] = True
            try:
                return profile(*args, **kw)
            finally:
                profiling[0] = False
        engine.profile = counted_profile
    spec = getattr(engine, "spec", None)
    if spec is not None and hasattr(spec.provider, "_ensure"):
        _instrument_draft(spec.provider, ec.counts)
    return ec
