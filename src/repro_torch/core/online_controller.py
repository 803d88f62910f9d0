"""The proposal: static IP placement + Algorithm 1 online light-MS control.

Greedy per-slot deployment: repeatedly evaluate, for every feasible
incremental deployment (one instance of light MS m on node v), the
marginal drift-plus-penalty change

  dL(v,m) = eta * c_new  -  sum_{j captured} phi * H_j * (defer_j - dT_j)

where dT_j = transfer + propagation + g_{m,eps}(y+1) (QoS-aware next-hop
latency, eq. below Alg. 1) and defer_j is what task j faces without the
new instance (its best existing instance, or one slot of queueing).
Implement the deployment with the most negative dL, repeat until none
helps; finally route every waiting task to its min-dT instance (lines
14-16), updating parallelism as we go.

The controller is vectorized (EXPERIMENTS.md §Vectorized engine): per
slot it builds one data-readiness matrix per waiting stage (tasks x
nodes, via the affine routed-path tables), evaluates every candidate
deployment's dL against whole node vectors per greedy round, and keeps
the virtual queues H_j in a flat tid-indexed array.  The pre-PR scalar
control flow is preserved decision-for-decision; the scalar reference
in `repro_torch.core.simulator_scalar` replays it loop-by-loop.

Interpretation notes vs. the paper's pseudocode are in
EXPERIMENTS.md §Algorithm 1 notes.

The port's copy of ``repro/core/online_controller.py`` (numpy only, line
for line), held against it on equal seeds by
tests/test_torch_simulator.py.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core import static_placement as sp
from repro_torch.core.effective_capacity import build_ec_maps
from repro_torch.core.lyapunov import ETA, PHI_DEFAULT, ZETA
from repro_torch.core.qos import qos_scores
from repro_torch.core.simulator import SLOT_MS, Simulator

Y_MAX = 16  # practical parallelism cap (duration scales with y_eff)


class ArrayQueues:
    """Virtual queues H_j (eq. 18) in a flat tid-indexed array —
    numerically identical to the dict-backed
    :class:`repro_torch.core.lyapunov.VirtualQueues`, but whole-cohort
    updates are one masked vector op per slot."""

    def __init__(self, zeta: float = ZETA):
        self.zeta = zeta
        self.h = np.full(256, zeta)

    def _ensure(self, n: int):
        cap = len(self.h)
        if n <= cap:
            return
        while cap < n:
            cap *= 2
        new = np.full(cap, self.zeta)
        new[:len(self.h)] = self.h
        self.h = new

    def admit(self, tid: int):
        self._ensure(tid + 1)
        self.h[tid] = self.zeta

    def get(self, tid: int) -> float:
        return float(self.h[tid]) if tid < len(self.h) else self.zeta

    def get_many(self, tids: np.ndarray) -> np.ndarray:
        self._ensure(int(tids.max()) + 1 if len(tids) else 0)
        return self.h[tids]

    def update_many(self, tids: np.ndarray, latency: np.ndarray,
                    deadline: np.ndarray):
        """Eq. (18): H <- max{H + T_j(t) - D_n, zeta}, batched."""
        self._ensure(int(tids.max()) + 1 if len(tids) else 0)
        self.h[tids] = np.maximum(self.h[tids] + latency - deadline,
                                  self.zeta)

    def drop(self, tid: int):
        pass  # finished tasks simply stop being updated/queried


class ProposalStrategy:
    """Two-tier: static core IP + effective-capacity Lyapunov controller."""

    name = "proposal"
    use_mean_estimate = False   # PropAvg ablation flips this

    def __init__(self, eps: float = 0.2, kappa: int = 8,
                 xi: float = sp.XI_DEFAULT, eta: float = ETA,
                 phi: float = PHI_DEFAULT, horizon_slots: int = 100,
                 bytes_per_param: float | None = None):
        self.eps = eps
        self.kappa = kappa
        self.xi = xi
        self.eta = eta
        self.phi = phi
        self.horizon = horizon_slots
        # weight bytes per parameter for the core services' memory
        # demand (None = the bf16 calibration; quantized re-runs pass
        # models.quantize.bytes_per_param(fmt))
        self.bytes_per_param = bytes_per_param
        self.queues = ArrayQueues(zeta=ZETA)

    # ------------------------------------------------------------------
    def place_core(self, app, net) -> Dict[int, np.ndarray]:
        self.app, self.net = app, net
        self.ec = build_ec_maps(app, self.eps)
        # per light MS: the g_{m,eps}(y) table (or the mean-value table
        # for the PropAvg ablation) and its parallelism cap
        self._g_tab = {
            m: (ec.mean_table if self.use_mean_estimate else ec.table)
            for m, ec in self.ec.items()}
        self._y_cap = {m: ec.y_max for m, ec in self.ec.items()}
        z, q = qos_scores(app, net)
        prob = sp.build_problem(app, net, z, q, kappa=self.kappa,
                                xi=self.xi, horizon_slots=self.horizon,
                                bytes_per_param=self.bytes_per_param)
        return sp.solve(prob)

    # ------------------------------------------------------------------
    def admit(self, task):
        self.queues.admit(task.id)

    def task_done(self, task):
        self.queues.drop(task.id)

    def end_slot(self, t: float, sim: Simulator):
        # eq. (18) update for tasks still in flight, as one vector op
        n = len(sim.tasks)
        ids = np.flatnonzero(sim.task_open[:n])
        if len(ids):
            self.queues.update_many(ids,
                                    (t + 1.0) - sim.task_t_gen[ids],
                                    sim.task_deadline[ids])

    # ------------------------------------------------------------------
    def _g(self, m: int, y) -> np.ndarray:
        """g_{m,eps}(y) table lookup, vectorized over y (clipped like
        ECMap.g)."""
        return self._g_tab[m][np.minimum(y, self._y_cap[m]) - 1]

    def assign_light(self, t: float, sim: Simulator,
                     waiting: List[tuple]) -> List[tuple]:
        app, net, store = sim.app, sim.net, sim.store
        waiting = [(tid, m) for tid, m in waiting]
        if not waiting:
            return []

        # live instances and remaining capacity (busy instances are
        # reusable — g_{m,eps}(y+1) prices their contention)
        alive = sim.alive_light_idx(t)
        store.refresh_y(alive, t)
        free_r = net.R - sim.light_resources_used(t)
        for m, xv in sim.x_cr.items():   # cores always reserve their share
            free_r -= xv[:, None] * app.ms(m).r[None, :]
        free_r = np.maximum(free_r, 0.0)

        # ---------------- per-stage matrices (one build per slot) -------
        stages = sorted({m for _, m in waiting})
        by_m = {m: [j for j, (_, mm) in enumerate(waiting) if mm == m]
                for m in stages}
        h_all = self.queues.get_many(
            np.array([tid for tid, _ in waiting], dtype=np.int64))
        # wait[m][row, v] = max(0, data_ready_at(m, v) - t): the
        # transfer+propagation half of dT for every (task, node) pair
        wait = {}
        row_of = {}
        for m in stages:
            rows = [np.maximum(
                sim.tasks[waiting[j][0]].data_ready_at_nodes(m, net) - t,
                0.0) for j in by_m[m]]
            wait[m] = np.stack(rows)
            row_of[m] = {j: r for r, j in enumerate(by_m[m])}
        # instance pools per stage (spawn order), and the defer vector:
        # best dT via an existing instance, floored by 1-slot queueing
        pools = {m: [int(i) for i in alive[store.m[alive] == m]]
                 for m in stages}
        defer = {}
        for m in stages:
            d = np.full(len(by_m[m]),
                        SLOT_MS + float(self._g(m, np.int64(1))))
            if pools[m]:
                pa = np.array(pools[m])
                dts = (wait[m][:, store.v[pa]]
                       + self._g(m, store.y_now[pa] + 1)[None, :])
                d = np.minimum(d, dts.min(axis=1))
            defer[m] = d

        dead = np.fromiter(sim.dead_nodes, dtype=np.int64) \
            if sim.dead_nodes else None

        # ---------------- greedy deployment loop (Algorithm 1) ----------
        while True:
            best_dl, best_v, best_m = 0.0, None, None
            for m in stages:
                ms = app.ms(m)
                feas = (free_r >= ms.r[None, :]).all(axis=1)
                if dead is not None:
                    feas[dead] = False
                vv = np.flatnonzero(feas)
                if not len(vv):
                    continue
                cost_new = self.eta * (ms.c_dp + ms.c_mt + ms.c_pl)
                w_sub = wait[m][:, vv]                       # J x F
                d_m = defer[m]
                y_hyp = np.zeros(len(vv), dtype=np.int64)
                gain = np.zeros(len(vv))
                # only tasks capturable on at least one candidate node
                # can move y_hyp or gain (g is increasing in y, so
                # wait + g(1) is a lower bound on their dT)
                g1 = float(self._g(m, np.int64(1)))
                js = np.flatnonzero(
                    ((w_sub + g1) < d_m[:, None]).any(axis=1))
                for j in js:
                    dt_new = w_sub[j] + self._g(m, y_hyp + 1)
                    cap = dt_new < d_m[j]
                    if cap.any():
                        gain = np.where(
                            cap,
                            gain + self.phi * h_all[by_m[m][j]]
                            * (d_m[j] - dt_new),
                            gain)
                        y_hyp += cap
                dl = cost_new - gain
                k = int(np.argmin(dl))
                if dl[k] < best_dl:
                    best_dl, best_v, best_m = float(dl[k]), int(vv[k]), m
            if best_v is None:
                break
            inst = sim.spawn_instance(best_v, best_m, t)
            pools[best_m].append(inst)
            free_r[best_v] -= app.ms(best_m).r
            # the fresh instance (y_now = 0) tightens only its stage's
            # defer vector
            defer[best_m] = np.minimum(
                defer[best_m],
                wait[best_m][:, best_v]
                + float(self._g(best_m, np.int64(1))))

        # ---------------- routing (lines 14-16) -------------------------
        order = sorted(range(len(waiting)), key=lambda j: -h_all[j])
        still = []
        pool_arr = {m: np.array(pools[m], dtype=np.int64) for m in stages}
        for j in order:
            tid, m = waiting[j]
            pa = pool_arr[m]
            if len(pa):
                ok = store.y_now[pa] < Y_MAX
                cand = pa[ok]
            else:
                cand = pa
            if not len(cand):
                still.append((tid, m))
                continue
            dts = (wait[m][row_of[m][j], store.v[cand]]
                   + self._g(m, store.y_now[cand] + 1))
            inst = int(cand[int(np.argmin(dts))])
            sim.commit_light(sim.tasks[tid], m, inst, now=t)
            store.y_now[inst] += 1
        return still


class PropAvgStrategy(ProposalStrategy):
    """Ablation: identical two-tier logic, mean-value delay estimates."""

    name = "prop_avg"
    use_mean_estimate = True
