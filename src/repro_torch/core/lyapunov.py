"""Lyapunov machinery (Sec. III-B): floored virtual queues (eq. 18) and
the drift-plus-penalty objective (eq. 19).

Notation (glossary in ``repro_torch.core.__init__``): H_j(t) is task j's
deadline-debt queue, zeta its floor, and eta the cost weight playing
the classic Lyapunov "V" role in the drift-plus-penalty trade-off —
larger eta buys lower cost at more latency-debt drift.

The port's copy of ``repro/core/lyapunov.py`` (numpy only, line for line),
held against it on equal seeds by tests/test_torch_planning.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

ZETA = 1.0       # queue floor (> 0: keeps the controller proactive)
# eta must stay small relative to phi*zeta*(slot benefit): the floor term
# is what makes the controller deploy BEFORE deadlines blow (the paper's
# zeta discussion); large eta starves fresh tasks whose H is still zeta.
ETA = 0.05
PHI_DEFAULT = 1.0


@dataclass
class VirtualQueues:
    """H_j(t) per active task j."""

    zeta: float = ZETA
    h: Dict[int, float] = field(default_factory=dict)

    def admit(self, task_id: int):
        self.h[task_id] = self.zeta

    def update(self, task_id: int, latency_so_far: float, deadline: float):
        """Eq. (18): H <- max{H + T_j(t) - D_n, zeta}."""
        cur = self.h.get(task_id, self.zeta)
        self.h[task_id] = max(cur + latency_so_far - deadline, self.zeta)

    def get(self, task_id: int) -> float:
        return self.h.get(task_id, self.zeta)

    def drop(self, task_id: int):
        self.h.pop(task_id, None)


def drift_plus_penalty_delta(cost_delta: float, h_j: float,
                             latency_delta: float, deadline_slack: float,
                             eta: float = ETA,
                             phi: float = PHI_DEFAULT) -> float:
    """Marginal change of eq. (19) for one incremental decision.

    L = eta * C_lt + sum_j phi_j H_j(t) [T_j(t) - D_n]; an assignment that
    adds `latency_delta` to task j and `cost_delta` to the bill changes L
    by eta*cost_delta + phi*H_j*(latency_delta - slack-release).
    """
    return eta * cost_delta + phi * h_j * (latency_delta - deadline_slack)
