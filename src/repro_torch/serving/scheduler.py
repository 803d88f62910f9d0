"""Scheduling policies for the serving engines (host side, no torch).

Port of the policy layer of ``repro/serving/scheduler.py``: the
admission verdicts, the :class:`CapacityView` a policy sees, and the
FIFO discipline the engines default to (head-of-line admission,
newest-admitted preemption victim, no admission test).  The
deadline-driven EDF and effective-capacity policies wait for the port
of their control-theory helpers.

Policies never touch token computation: they reorder *which* request
is admitted or preempted, never *what* it computes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

# admission-test verdicts
ADMIT = "admit"
DEFER = "defer"     # head-of-line wait: nothing overtakes the choice
REJECT = "reject"


@dataclass
class CapacityView:
    """Engine-agnostic capacity snapshot handed to
    :meth:`SchedulerPolicy.admission_test`.  ``granule`` is the
    allocation unit in tokens (the paged block size)."""

    free_tokens: int     # tokens admissible right now (above watermark)
    total_tokens: int    # whole pool
    granule: int         # allocation unit (block_size)
    # prefix-sharing probe: tokens -> blocks an admission would *share*
    # rather than allocate (PagedCache.probe_hit; None without an index)
    shared_blocks: Optional[Callable[[List[int]], int]] = None
    # speculative speedup: mean tokens emitted per live row per verify
    # round (the engine's spec_accept_mean(); 1.0 when off).  FIFO ignores
    # it; the effective-capacity test of the reference scales its fixed
    # service-time priors by it.
    spec_accept: float = 1.0

    def blocks(self, n_tokens: int) -> int:
        return -(-n_tokens // self.granule)

    @property
    def free_blocks(self) -> int:
        return self.free_tokens // self.granule


class SchedulerPolicy:
    """Scheduling hooks the engines delegate to.  The base class IS the
    FIFO discipline; subclasses override the decision points:

    * :meth:`next_admission` — which queued request to try next
      (head-of-line: a DEFER/blocked choice is never overtaken);
    * :meth:`admission_test` — ``(ADMIT | DEFER | REJECT, message)``;
    * :meth:`select_victim` — which active request to preempt when the
      pool is exhausted (``None`` = the needy row preempts itself);
    * :meth:`on_step` / :meth:`on_done` and friends — observation hooks.

    ``max_preemptions`` (``None`` = unlimited) bounds preemption churn.
    """

    name = "fifo"
    max_preemptions: Optional[int] = None

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

    def on_submit(self, req, t: int):
        pass

    def on_step(self, t: int, queue: List, running: List):
        pass

    def on_done(self, req, t: int):
        pass

    def on_preempt(self, req, t: int):
        pass

    def on_free(self, n_blocks: int, t: int):
        pass


FIFOPolicy = SchedulerPolicy  # the base class IS the FIFO discipline
POLICIES = {"fifo": SchedulerPolicy}


def make_policy(policy, **kw) -> SchedulerPolicy:
    """``None`` / name / instance -> a fresh policy object (policies
    hold per-engine state, so engines must never share one)."""
    if policy is None:
        return FIFOPolicy()
    if isinstance(policy, SchedulerPolicy):
        return policy
    try:
        return POLICIES[policy](**kw)
    except KeyError:
        raise ValueError(f"unknown scheduler policy {policy!r}; "
                         f"known: {sorted(POLICIES)}") from None
