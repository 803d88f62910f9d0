"""Mean-value analysis heuristics for static core placement (Sec. III-A).

For a typical task of type n requiring core MS m at node v:
  d_pr(v, m): preceding latency — mean-value completion time of m's
              parents, routed along shortest (network + mean compute) paths
              from the task's source user to v;
  d_cu(v, m): processing time a_m / f_m at v;
  d_su(v, m): succeeding latency — sum of mean processing of descendants.

Then (eq. 15): load estimate z~_{v,m} apportions each (u, n)'s arrival
rate over nodes by exp(-delta * d_pr); and (eq. 16): urgency
d~ = capped ratio of remaining budget to future work, Q = z~ * d~.

The port's copy of ``repro/core/qos.py`` (numpy only, line for line),
held against it on equal seeds by tests/test_torch_planning.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.graph import Application, TaskType
from repro_torch.core.network import EdgeNetwork

DELTA = 0.05     # exponential-decay load apportioning constant
C1_FLOOR = 0.5   # constant C1 in the urgency metric (floor of the ratio)
URG_CAP = 50.0   # numerical-sanity cap (d_su -> 0 for sink-adjacent MSs)


@dataclass
class MeanLatencyModel:
    """Mean-value latency primitives shared by QoS scoring and baselines."""

    app: Application
    net: EdgeNetwork

    def __post_init__(self):
        self._memo = {}

    def mean_proc(self, m: int) -> float:
        return self.app.ms(m).mean_proc_ms()

    def d_pr_vec(self, u: int, tt: TaskType, m: int) -> np.ndarray:
        """Mean completion time of everything before m, for every
        candidate node v at once.

        Recursive eq. (4) with mean values; parent services are assumed
        placed along the min-latency node (shortest-path relaxation of
        the circular routing dependency — see the reference's design notes).  Each
        parent hop is one min-plus matrix reduction over the node mesh
        (the old per-(v, v') double loop recursed millions of times on
        scale_load topologies).  Memoized per (u, type, m)."""
        key = (u, tt.idx, m)
        if key in self._memo:
            return self._memo[key]
        ed = self.net.user_ed[u]
        parents = tt.parents(m)
        if not parents:
            # first service: uplink + transfer of the input payload
            up = self.net.mean_uplink_ms(u, tt.payload)
            out = up + (self.net.net_ms[ed] / 1.0) * tt.payload
        else:
            vals = []
            for p in parents:
                # parent served at its own best node v', then ships b_p
                # to v: best[v] = min_v' (prev[v'] + net_ms[v', v] * b_p)
                prev = self.d_pr_vec(u, tt, p) + self.mean_proc(p)
                vals.append((prev[:, None] + (self.net.net_ms / 1.0)
                             * self.app.ms(p).b).min(axis=0))
            out = np.maximum.reduce(vals)
        self._memo[key] = out
        return out

    def d_pr(self, u: int, tt: TaskType, v: int, m: int) -> float:
        """Scalar view of :meth:`d_pr_vec` (kept for API compat)."""
        return float(self.d_pr_vec(u, tt, m)[v])

    def d_su(self, tt: TaskType, m: int) -> float:
        return sum(self.mean_proc(d) for d in tt.descendants(m))


def qos_scores(app: Application, net: EdgeNetwork):
    """Returns (z_tilde, Q): both (V, M_core-indexed dict of arrays)."""
    model = MeanLatencyModel(app, net)
    v_n = net.n_nodes
    core = app.core_ids
    z_tilde = {m: np.zeros(v_n) for m in core}
    q_score = {m: np.zeros(v_n) for m in core}

    for m in core:
        for tt in app.types_using(m):
            d_su = model.d_su(tt, m)
            d_cu = model.mean_proc(m)
            # Little's law: concurrent load = arrival rate x service time
            # (constraint (10) counts tasks *in service*, not arrivals)
            conc = tt.rate * model.mean_proc(m)
            for u in range(net.n_users):
                d_pre = model.d_pr_vec(u, tt, m)
                # eq. (15): exponential-decay apportioning of E[z]
                wgt = np.exp(-DELTA * d_pre)
                wgt = wgt / wgt.sum()
                z_tilde[m] += wgt * conc
                # eq. (16) upper: max{remaining budget / future work, C1}
                # — Q rewards placements whose tasks *comfortably* meet
                # deadlines (paper Sec. III-A); URG_CAP guards d_su -> 0
                denom = max(d_su, 1e-3)
                ratio = (tt.deadline - d_pre - d_cu) / denom
                urg = np.clip(ratio, C1_FLOOR, URG_CAP)
                q_score[m] += wgt * tt.rate * urg
    return z_tilde, q_score
