"""SLO-goodput scheduling policies for the serving engines (host side,
no torch).

The port's copy of ``repro/serving/scheduler.py``, line for line: the
paper's control theory (Sec. III-B) in the serving layer.  Requests
carry a **QoS class** with TTFT/TPOT deadlines (engine-clock steps,
:class:`QoSClass`), and the engines' admit / preempt decisions are
delegated to a pluggable :class:`SchedulerPolicy`.  Three policies ship:

``fifo`` (:class:`FIFOPolicy`)
    Head-of-line FIFO admission, LIFO (newest-admitted) preemption
    victims, no admission test.  The default.
``edf`` (:class:`EDFPolicy`)
    Earliest-deadline-first admission over a *slack-aged* deadline key
    with per-class Lyapunov virtual queues
    (:class:`repro_torch.core.lyapunov.VirtualQueues`, eq. 18) driving
    urgency bursts, and deadline-aware preemption: the victim is the
    active request with the **most** slack, never one about to meet
    its TTFT deadline.
``edf_ec`` (:class:`EDFCapacityPolicy`)
    EDF plus an **effective-capacity admission test**
    (:func:`repro_torch.core.effective_capacity.latency_budget`, eq.
    21): a request that must wait for pool blocks is admitted only if
    the Gamma-modelled block-freeing process covers its deficit within
    its remaining TTFT slack at the class's violation probability —
    else it is rejected up front (``Request.error``).

Policies never touch token computation: they reorder *which* request
is admitted or preempted, and greedy decode keeps every request's
token stream independent of that order (tests/test_torch_policy.py
holds FIFO and EDF streams equal, and both to the reference's).

**Goodput** — the fraction of submitted requests meeting both
deadlines — is the metric this layer optimizes (:func:`goodput`):

* TTFT (time to first token): ``t_first - t_submit <= cls.ttft``;
* TPOT (time per output token): the remaining tokens must average
  ``cls.tpot`` steps, ``t_done - t_first <= cls.tpot * (n - 1)``.

All deadline arithmetic is in engine steps (one decode iteration), so
goodput is deterministic given a trace — unlike wall-clock tokens/s.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.effective_capacity import latency_budget
from repro_torch.core.lyapunov import VirtualQueues

# admission-test verdicts
ADMIT = "admit"
DEFER = "defer"     # head-of-line wait: nothing overtakes the choice
REJECT = "reject"


@dataclass(frozen=True)
class QoSClass:
    """One service tier: deadlines in engine-clock steps.

    ``ttft``
        steps allowed from ``t_submit`` to the first emitted token.
    ``tpot``
        steps allowed per output token after the first (the stream
        must *average* this rate, macro-step bursts included).
    ``eps``
        latency-violation probability target — the effective-capacity
        admission test's tail bound (paper eq. 21 ``eps``).
    ``phi``
        virtual-queue weight (paper eq. 19 ``phi_j``): how hard this
        class's deadline debt pulls the EDF key during urgency bursts.
    """

    name: str
    ttft: int
    tpot: float
    eps: float
    phi: float = 1.0


#: Default tiers.  TTFT spans ~1.5 decades so EDF has real choices to
#: make; ``batch`` relies on slack aging to avoid starvation.
QOS_CLASSES: Dict[str, QoSClass] = {
    "interactive": QoSClass("interactive", ttft=16, tpot=2.0,
                            eps=0.05, phi=4.0),
    "standard": QoSClass("standard", ttft=48, tpot=4.0,
                         eps=0.10, phi=1.0),
    "batch": QoSClass("batch", ttft=512, tpot=16.0,
                      eps=0.25, phi=0.25),
}


def get_qos(name: str) -> QoSClass:
    try:
        return QOS_CLASSES[name]
    except KeyError:
        raise KeyError(f"unknown QoS class {name!r}; "
                       f"known: {sorted(QOS_CLASSES)}") from None


# ----------------------------------------------------------------------
# SLO accounting (pure functions of Request stamps)
# ----------------------------------------------------------------------
def ttft_met(req, cls: Optional[QoSClass] = None) -> bool:
    cls = cls or get_qos(req.qos)
    return (req.t_first is not None
            and req.t_first - req.t_submit <= cls.ttft)


def tpot_met(req, cls: Optional[QoSClass] = None) -> bool:
    cls = cls or get_qos(req.qos)
    n = len(req.out_tokens)
    if n <= 1:
        return True
    return req.t_done - req.t_first <= cls.tpot * (n - 1)


def slo_met(req) -> bool:
    """Did this request meet both deadlines?  Rejected and unfinished
    requests count as misses (they produced no on-time stream)."""
    if req.error is not None or req.t_done is None or not req.done:
        return False
    cls = get_qos(req.qos)
    return ttft_met(req, cls) and tpot_met(req, cls)


def goodput(requests: Sequence) -> float:
    """Fraction of submitted requests meeting TTFT **and** TPOT."""
    if not requests:
        return 0.0
    return sum(1 for r in requests if slo_met(r)) / len(requests)


def per_class_stats(requests: Sequence) -> Dict[str, Dict[str, float]]:
    """On-time accounting per QoS class: n, on-time, rejected, goodput
    and mean TTFT of each."""
    out: Dict[str, Dict[str, float]] = {}
    for r in requests:
        s = out.setdefault(r.qos, {"n": 0, "on_time": 0, "rejected": 0,
                                   "ttft_sum": 0.0, "ttft_n": 0})
        s["n"] += 1
        s["on_time"] += int(slo_met(r))
        s["rejected"] += int(r.error is not None)
        if r.t_first is not None:
            s["ttft_sum"] += r.t_first - r.t_submit
            s["ttft_n"] += 1
    for s in out.values():
        s["goodput"] = s["on_time"] / s["n"]
        s["ttft_mean"] = (s["ttft_sum"] / s["ttft_n"]) if s["ttft_n"] else 0.0
        del s["ttft_sum"], s["ttft_n"]
    return out


# ----------------------------------------------------------------------
# What a policy may see of the engine's capacity
# ----------------------------------------------------------------------
@dataclass
class CapacityView:
    """Engine-agnostic capacity snapshot handed to
    :meth:`SchedulerPolicy.admission_test`.  ``granule`` is the
    allocation unit in tokens: the paged block size, or a full
    ``cache_len`` row for the dense engines (slot-granular admission
    is just paging with one huge block)."""

    free_tokens: int     # tokens admissible right now (above watermark)
    total_tokens: int    # whole pool
    granule: int         # allocation unit (block_size / cache_len)
    # prefix-sharing probe: tokens -> blocks an admission would *share*
    # rather than allocate (PagedCache.probe_hit; None when the engine
    # has no prefix index).  A cache hit shrinks the modeled service
    # demand in the effective-capacity admission test.
    shared_blocks: Optional[Callable[[List[int]], int]] = None
    # speculative-decoding speedup: mean tokens emitted per live row
    # per verify round (engine spec_accept_mean(); 1.0 when off).  The
    # effective-capacity test scales *fixed* service-time priors by it
    # — online-learned stats already observe the accelerated process.
    spec_accept: float = 1.0

    def blocks(self, n_tokens: int) -> int:
        return -(-n_tokens // self.granule)

    @property
    def free_blocks(self) -> int:
        return self.free_tokens // self.granule


# ----------------------------------------------------------------------
# Policy layer
# ----------------------------------------------------------------------
class SchedulerPolicy:
    """Scheduling hooks the engines delegate to (SERVING.md
    §Scheduling).  The base class IS the FIFO discipline; subclasses
    override the four decision points:

    * :meth:`next_admission` — which queued request to try next
      (head-of-line: a DEFER/blocked choice is never overtaken);
    * :meth:`admission_test` — ``(ADMIT | DEFER | REJECT, message)``
      *before first admission* (resumed requests always pass);
    * :meth:`select_victim` — which active request to preempt when the
      pool is exhausted (``None`` = the needy row preempts itself);
    * :meth:`on_step` / :meth:`on_done` — per-step observation hooks
      (virtual queues, service-rate estimation).

    ``max_preemptions`` (``None`` = unlimited) bounds preemption churn:
    a request preempted that many times is evicted to
    ``engine.rejected`` instead of requeued
    (``_PagedEngine._preempt``).  Policies decide *which* rows run,
    never *what* they compute — token streams are policy-invariant
    (tests/test_torch_policy.py goodput parity sweep).
    """

    name = "fifo"
    max_preemptions: Optional[int] = None

    # -------------------------------------------------------- decisions
    def next_admission(self, queue: List, t: int):
        """The request to try admitting next (FIFO: the queue head)."""
        return queue[0] if queue else None

    def admission_test(self, req, t: int,
                       view: Optional[CapacityView]) -> Tuple[str, Optional[str]]:
        return ADMIT, None

    def select_victim(self, candidates: List[Tuple[int, object]],
                      t: int, needy: int) -> Optional[int]:
        """``candidates`` = active ``(row, request)`` pairs in admission
        order (oldest first).  FIFO/LIFO: preempt the newest."""
        return candidates[-1][0] if candidates else None

    # ------------------------------------------------------ observation
    def on_submit(self, req, t: int):
        pass

    def on_step(self, t: int, queue: List, running: List):
        pass

    def on_done(self, req, t: int):
        pass

    def on_preempt(self, req, t: int):
        pass

    def on_free(self, n_blocks: int, t: int):
        """``n_blocks`` allocation granules returned to the pool
        (completion releases) — service-rate observation hook."""
        pass


class EDFPolicy(SchedulerPolicy):
    """Earliest-deadline-first admission + most-slack preemption.

    The admission key of a queued request is its next deadline, pulled
    earlier by two pressure terms::

        key = deadline - age_rate * wait - phi_c * (H_c - zeta)

    * ``deadline`` — ``t_submit + ttft`` for a fresh request, or the
      *next-token* deadline ``t_first + tpot * (n_out + 1)`` for a
      preempted request resuming mid-stream;
    * **slack aging** — ``age_rate * wait`` guarantees a starving
      ``batch`` request overtakes an endless stream of fresh
      ``interactive`` arrivals within a bounded number of steps
      (tests/test_torch_policy.py pins the bound);
    * **urgency bursts** — per-class virtual queues ``H_c``
      (eq. 18: ``H <- max(H + wait_c - ttft_c, zeta)``, updated once
      per engine step with the class's longest queued wait) push a
      whole class forward once its deadline debt accumulates,
      Lyapunov-style; ``phi_c`` weights the push.

    Preemption victims are chosen by **most slack** (the request that
    can best afford a recompute round-trip), never a request still
    awaiting its first token whose TTFT deadline is within
    ``ttft_protect`` steps; ties break to the newest admission (the
    FIFO/LIFO tiebreak, keeping victim choice deterministic).
    ``max_preemptions`` defaults to 8: a request bounced that often is
    evicted rather than thrashed forever.
    """

    name = "edf"

    def __init__(self, *, age_rate: float = 0.5, ttft_protect: int = 4,
                 max_preemptions: Optional[int] = 8):
        self.age_rate = age_rate
        self.ttft_protect = ttft_protect
        self.max_preemptions = max_preemptions
        self.vq = VirtualQueues()

    # -------------------------------------------------------------- keys
    def deadline(self, req) -> float:
        cls = get_qos(req.qos)
        if req.t_first is not None:  # resuming mid-stream: next token due
            return req.t_first + cls.tpot * (len(req.out_tokens) + 1)
        return req.t_submit + cls.ttft

    def admission_key(self, req, t: int) -> float:
        cls = get_qos(req.qos)
        h_boost = cls.phi * (self.vq.get(req.qos) - self.vq.zeta)
        return (self.deadline(req) - self.age_rate * (t - req.t_submit)
                - h_boost)

    def slack(self, req, t: int) -> float:
        return self.deadline(req) - t

    # -------------------------------------------------------- decisions
    def next_admission(self, queue: List, t: int):
        if not queue:
            return None
        return min(queue, key=lambda r: (self.admission_key(r, t),
                                         r.t_submit, r.id))

    def select_victim(self, candidates, t: int, needy: int):
        def protected(req) -> bool:
            # still awaiting its first token with TTFT almost due:
            # preempting it guarantees the miss (already-missed
            # requests get no protection — nothing left to save)
            cls = get_qos(req.qos)
            return (req.t_first is None and not req.out_tokens
                    and 0 <= req.t_submit + cls.ttft - t
                    <= self.ttft_protect)

        eligible = [(row, req) for row, req in candidates
                    if not protected(req)]
        if not eligible:
            return None
        # most slack first; ties -> newest admission (candidates arrive
        # oldest-first, so max() keeps the last of equals)
        best, _ = max(enumerate(eligible),
                      key=lambda e: (self.slack(e[1][1], t), e[0]))
        return eligible[best][0]

    # ------------------------------------------------------ observation
    def on_step(self, t: int, queue: List, running: List):
        """Eq. (18) drift, once per engine step: each class's H moves
        by its longest queued *fresh* wait minus its TTFT budget,
        floored at zeta; classes with nothing queued drain."""
        waits: Dict[str, float] = {}
        for req in queue:
            if req.t_admit is None:
                waits[req.qos] = max(waits.get(req.qos, 0.0),
                                     float(t - req.t_submit))
        for name in set(waits) | set(self.vq.h):
            self.vq.update(name, waits.get(name, 0.0), get_qos(name).ttft)


class EDFCapacityPolicy(EDFPolicy):
    """EDF plus the paper's effective-capacity admission test.

    The block pool's freeing process (blocks released by completions
    per engine step) is modelled as i.i.d. Gamma increments — the same
    service model eq. (20) applies to light-MS rates — with
    ``(shape, scale)`` either supplied or moment-matched online from
    an EWMA of observed per-step frees.  A fresh request that does not
    fit the free pool right now is admitted into the wait only if

        latency_budget(shape, scale, cls.eps, deficit_blocks)
            <= remaining TTFT slack

    (eq. 21's Chernoff inversion, :func:`repro_torch.core.
    effective_capacity.latency_budget`): the smallest statistically-safe time for the
    pool to free its block deficit, at the class's violation
    probability ``eps``.  Otherwise the request is **rejected before
    first admission** — ``t_done`` stamped, ``Request.error`` carrying
    the class name — mirroring the oversized-request ``_reject`` path,
    so capacity is spent only on requests that can still make their
    deadline.  A request whose TTFT slack is already spent is rejected
    on the same path without consulting the model.  Requests that were
    already admitted once (preemption resumes) always pass: their
    admission contract was honoured at first admission.
    """

    name = "edf_ec"

    #: EWMA weight, minimum samples before the online estimate is
    #: trusted (before that the test falls back to plain EDF deferral),
    #: and the sampling window in engine steps.  Completions free
    #: several blocks in one step, so per-step samples are almost all
    #: zero with rare spikes — moment matching them yields a
    #: pathologically small Gamma shape (near-zero effective capacity
    #: and astronomical budgets).  Summing frees over a window averages
    #: the burstiness out; Gamma additivity maps the window estimate
    #: back to per-step ``(shape / W, scale)``.
    EWMA_ALPHA = 0.25
    MIN_SAMPLES = 4
    SAMPLE_WINDOW = 16

    def __init__(self, *, service_shape: Optional[float] = None,
                 service_scale: Optional[float] = None, **kw):
        super().__init__(**kw)
        self._fixed = (service_shape, service_scale)
        self._mean = 0.0       # EWMA of blocks freed per window
        self._mean_sq = 0.0
        self._n_samples = 0
        self._freed = 0.0      # blocks freed in the open window
        self._window_steps = 0
        self._last_t: Optional[int] = None

    # ---------------------------------------------------- service model
    def service_stats(self) -> Tuple[Optional[float], Optional[float]]:
        """Per-engine-step Gamma ``(shape, scale)`` of the block-freeing
        process: the fixed override, else the windowed moment-matched
        EWMA estimate (``None`` until warmed up — the test then defers
        instead of rejecting on a cold model)."""
        if self._fixed[0] is not None:
            return self._fixed
        if self._n_samples < self.MIN_SAMPLES:
            return None, None
        var = max(self._mean_sq - self._mean ** 2, 1e-9)
        mean = self._mean
        if mean <= 1e-9:
            return None, None
        shape_w, scale_w = mean * mean / var, var / mean
        return shape_w / self.SAMPLE_WINDOW, scale_w

    def _observe(self, freed: float):
        a = self.EWMA_ALPHA
        self._mean = (1 - a) * self._mean + a * freed
        self._mean_sq = (1 - a) * self._mean_sq + a * freed * freed
        self._n_samples += 1

    def on_step(self, t: int, queue: List, running: List):
        super().on_step(t, queue, running)
        if self._last_t is not None and t > self._last_t:
            self._window_steps += t - self._last_t
            while self._window_steps >= self.SAMPLE_WINDOW:
                self._observe(self._freed)
                self._freed = 0.0
                self._window_steps -= self.SAMPLE_WINDOW
        self._last_t = t

    def on_free(self, n_blocks: int, t: int):
        """Engine callback: ``n_blocks`` (granules) returned to the
        pool — completion releases, counted into the current step's
        service sample."""
        self._freed += max(0, n_blocks)

    # -------------------------------------------------------- admission
    def admission_test(self, req, t: int, view: Optional[CapacityView]):
        if req.t_admit is not None or view is None:
            return ADMIT, None
        cls = get_qos(req.qos)
        slack = req.t_submit + cls.ttft - t
        if slack < 0:
            return REJECT, (
                f"{cls.name}: TTFT deadline exhausted before admission "
                f"(waited {t - req.t_submit} > ttft {cls.ttft} steps)")
        need_now = view.blocks(len(req.prompt) + len(req.out_tokens))
        if view.shared_blocks is not None:
            # a prefix-cache hit maps blocks instead of allocating them:
            # the modeled service demand shrinks by the shared span
            need_now -= view.shared_blocks(
                (req.prompt + req.out_tokens)[:-1])
        deficit = need_now - view.free_blocks
        if deficit <= 0:
            return ADMIT, None
        shape, scale = self.service_stats()
        if shape is None:
            return DEFER, None
        if self._fixed[0] is not None and view.spec_accept > 1.0:
            # speculative decoding emits spec_accept tokens per row per
            # step on average, so rows finish — and free blocks — that
            # much faster.  Scaling the Gamma *scale* multiplies the
            # mean freeing rate while keeping its shape (burstiness).
            # Only fixed priors are discounted: the windowed EWMA
            # estimate already observes the accelerated process.
            scale = scale * view.spec_accept
        d = latency_budget(shape, scale, cls.eps, float(deficit))
        if d > slack:
            return REJECT, (
                f"{cls.name}: effective-capacity admission test predicts "
                f"{d:.1f} steps to free {deficit} blocks > remaining TTFT "
                f"slack {slack} (eps={cls.eps})")
        return DEFER, None


POLICIES = {
    "fifo": SchedulerPolicy,
    "edf": EDFPolicy,
    "edf_ec": EDFCapacityPolicy,
}
FIFOPolicy = SchedulerPolicy  # the base class IS the FIFO discipline


def make_policy(policy, **kw) -> SchedulerPolicy:
    """``None`` / name / instance -> a fresh policy object (policies
    hold per-engine state — virtual queues, service estimates — so
    engines must never share one)."""
    if policy is None:
        return FIFOPolicy()
    if isinstance(policy, SchedulerPolicy):
        return policy
    try:
        return POLICIES[policy](**kw)
    except KeyError:
        raise ValueError(f"unknown scheduler policy {policy!r}; "
                         f"known: {sorted(POLICIES)}") from None
