"""Baselines from Sec. IV: LBRR, GA (PropAvg lives in online_controller).

The port's copy of ``repro/core/baselines.py`` (numpy only, line for
line), held against it on equal seeds by tests/test_torch_simulator.py.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.simulator import Simulator

Y_FIXED = 4   # LBRR / GA fixed parallelism level


def _demand_per_ms(app) -> Dict[int, float]:
    """Mean arrival-rate-weighted load (tasks/ms) per MS."""
    d = {m.idx: 0.0 for m in app.services}
    n_users = 1
    for tt in app.task_types:
        for m in tt.ms_ids:
            d[m] += tt.rate
    return d


def _core_demand_counts(app, net) -> Dict[int, int]:
    """Instances needed so aggregate service rate covers mean load."""
    out = {}
    for m in app.core_ids:
        ms = app.ms(m)
        load = sum(tt.rate for tt in app.types_using(m)) * net.n_users
        per_inst = ms.f_det / ms.a      # tasks/ms one instance sustains
        out[m] = max(1, int(np.ceil(load / per_inst)))
    return out


def _light_need(app, net, m, headroom: float = 1.0) -> int:
    """Little's-law replica count for light MS m at parallelism Y_FIXED."""
    ms = app.ms(m)
    load = sum(tt.rate for tt in app.types_using(m)) * net.n_users
    dur = ms.a * Y_FIXED / max(ms.f_mean, 1e-6)
    return max(1, int(np.ceil(headroom * load * dur / Y_FIXED)))


def _static_light_placement(app, net, counts: Dict[int, int],
                            used: np.ndarray) -> Dict[int, np.ndarray]:
    """Least-loaded static allocation of light replicas."""
    x = {m: np.zeros(net.n_nodes, dtype=int) for m in app.light_ids}
    for m, count in counts.items():
        r = app.ms(m).r
        for _ in range(count):
            with np.errstate(divide="ignore", invalid="ignore"):
                util = np.nanmax(
                    np.where(net.R > 0, (used + r) / net.R, np.inf), axis=1)
            fits = ((net.R - used) >= r).all(axis=1)
            util[~fits] = np.inf
            v = int(np.argmin(util))
            if not np.isfinite(util[v]):
                break
            x[m][v] += 1
            used[v] += r
    return x


# ----------------------------------------------------------------------
# LBRR: least-loaded STATIC allocation + round-robin scheduling
# (paper: "Services are allocated to the least-loaded nodes.  Incoming
#  tasks are then scheduled across available instances using Round-Robin")
# ----------------------------------------------------------------------
class LBRRStrategy:
    name = "lbrr"

    def __init__(self, **_):
        self._rr = 0

    def place_core(self, app, net) -> Dict[int, np.ndarray]:
        self.app, self.net = app, net
        x = {m: np.zeros(net.n_nodes, dtype=int) for m in app.core_ids}
        used = np.zeros_like(net.R)
        for m, count in _core_demand_counts(app, net).items():
            r = app.ms(m).r
            for _ in range(count):
                with np.errstate(divide="ignore", invalid="ignore"):
                    util = np.nanmax(
                        np.where(net.R > 0, (used + r) / net.R, np.inf),
                        axis=1)
                fits = ((net.R - used) >= r).all(axis=1)
                util[~fits] = np.inf
                v = int(np.argmin(util))
                if not np.isfinite(util[v]):
                    break
                x[m][v] += 1
                used[v] += r
        self._used = used
        return x

    def init_light(self, sim: Simulator):
        app, net = self.app, self.net
        counts = {m: _light_need(app, net, m, headroom=1.0)
                  for m in app.light_ids}
        x_lt = _static_light_placement(app, net, counts, self._used)
        for m, xv in x_lt.items():
            for v in range(net.n_nodes):
                for _ in range(int(xv[v])):
                    sim.spawn_instance(v, m, 0.0, persistent=True)

    def assign_light(self, t: float, sim: Simulator,
                     waiting: List[tuple]) -> List[tuple]:
        store = sim.store
        alive = sim.alive_light_idx(t)
        store.refresh_y(alive, t)
        pools = {m: alive[store.m[alive] == m]
                 for m in {mm for _, mm in waiting}}
        still = []
        for tid, m in waiting:
            pa = pools[m]
            cand = pa[store.y_now[pa] < Y_FIXED] if len(pa) else pa
            if not len(cand):
                still.append((tid, m))   # deadline-agnostic queueing
                continue
            inst = int(cand[self._rr % len(cand)])
            self._rr += 1
            sim.commit_light(sim.tasks[tid], m, inst, now=t)
            store.y_now[inst] += 1
        return still


# ----------------------------------------------------------------------
# GA: metaheuristic static deployment of cores + light replica counts
# ----------------------------------------------------------------------
class GAStrategy:
    name = "ga"

    def __init__(self, pop: int = 24, gens: int = 30, seed: int = 0,
                 viol_weight: float = 40000.0, **_):
        self.pop = pop
        self.gens = gens
        self.rng = np.random.default_rng(seed)
        self.viol_weight = viol_weight

    # -- fitness: cost + weighted QoS-violation estimate ---------------
    def _fitness(self, genome) -> float:
        app, net = self.app, self.net
        x_cr, x_lt = genome
        cost = 0.0
        for m in app.core_ids:
            ms = app.ms(m)
            cost += (ms.c_dp + ms.c_mt * 100) * x_cr[m].sum()
        for m in app.light_ids:
            ms = app.ms(m)
            cost += (ms.c_dp + (ms.c_mt + ms.c_pl) * 100) * x_lt[m].sum()
        # capacity feasibility penalty
        used = np.zeros_like(net.R)
        for m in app.core_ids:
            used += x_cr[m][:, None] * app.ms(m).r[None, :]
        for m in app.light_ids:
            used += x_lt[m][:, None] * app.ms(m).r[None, :]
        over = np.maximum(used - net.R, 0).sum()
        # mean-value E2E estimate per task type with queueing inflation
        viol = 0.0
        for tt in app.task_types:
            est = self.mlm.mean_uplink(tt)
            unservable = False
            for m in tt.ms_ids:
                ms = app.ms(m)
                x = x_cr[m] if ms.is_core else x_lt[m]
                n_inst = max(int(x.sum()), 0)
                load = sum(t2.rate for t2 in app.types_using(m)) * net.n_users
                if n_inst == 0:
                    unservable = True
                    continue
                per_inst = (ms.f_det / ms.a if ms.is_core
                            else ms.f_mean / (ms.a * Y_FIXED))
                rho = load / max(n_inst * per_inst, 1e-6)
                infl = 1.0 / max(1.0 - min(rho, 0.95), 0.05)
                base = (ms.a / ms.f_det if ms.is_core
                        else ms.a * Y_FIXED / ms.f_mean)
                est += base * infl + 1.0  # + mean hop
            if unservable:
                viol += 1.0
            else:
                viol += max(0.0, np.tanh((est - tt.deadline) / tt.deadline))
        viol /= len(app.task_types)
        return cost + self.viol_weight * viol + 50.0 * over

    def _random_genome(self):
        app, net = self.app, self.net
        x_cr = {m: np.zeros(net.n_nodes, dtype=int) for m in app.core_ids}
        x_lt = {m: np.zeros(net.n_nodes, dtype=int) for m in app.light_ids}
        demand = _core_demand_counts(app, net)
        for m in app.core_ids:
            for _ in range(max(1, demand[m] + self.rng.integers(-1, 2))):
                x_cr[m][self.rng.integers(net.n_nodes)] += 1
        for m in app.light_ids:
            n = max(1, _light_need(app, net, m) + self.rng.integers(-1, 3))
            for _ in range(n):
                x_lt[m][self.rng.integers(net.n_nodes)] += 1
        return (x_cr, x_lt)

    def _mutate(self, genome):
        x_cr = {m: v.copy() for m, v in genome[0].items()}
        x_lt = {m: v.copy() for m, v in genome[1].items()}
        tbl = x_cr if self.rng.random() < 0.5 else x_lt
        m = list(tbl)[self.rng.integers(len(tbl))]
        v = self.rng.integers(len(tbl[m]))
        if self.rng.random() < 0.5:
            tbl[m][v] += 1
        elif tbl[m][v] > 0:
            tbl[m][v] -= 1
        return (x_cr, x_lt)

    def _crossover(self, g1, g2):
        x_cr = {m: (g1[0][m] if self.rng.random() < 0.5 else g2[0][m]).copy()
                for m in g1[0]}
        x_lt = {m: (g1[1][m] if self.rng.random() < 0.5 else g2[1][m]).copy()
                for m in g1[1]}
        return (x_cr, x_lt)

    def place_core(self, app, net) -> Dict[int, np.ndarray]:
        self.app, self.net = app, net

        class _MLM:
            def __init__(self, net):
                self.net = net

            def mean_uplink(self, tt):
                return float(np.mean([
                    self.net.mean_uplink_ms(u, tt.payload)
                    for u in range(self.net.n_users)]))

        self.mlm = _MLM(net)
        pop = [self._random_genome() for _ in range(self.pop)]
        fits = [self._fitness(g) for g in pop]
        for _ in range(self.gens):
            order = np.argsort(fits)
            elite = [pop[i] for i in order[:max(2, self.pop // 4)]]
            children = []
            while len(children) < self.pop - len(elite):
                a, b = self.rng.integers(len(elite), size=2)
                child = self._mutate(self._crossover(elite[a], elite[b]))
                children.append(child)
            pop = elite + children
            fits = [self._fitness(g) for g in pop]
        self.best = pop[int(np.argmin(fits))]
        # light replica plan is deployed statically (GA is a one-shot
        # deployment optimizer)
        self._light_plan = self.best[1]
        return self.best[0]

    def init_light(self, sim: Simulator):
        for m, xv in self._light_plan.items():
            for v in range(self.net.n_nodes):
                for _ in range(int(xv[v])):
                    sim.spawn_instance(v, m, 0.0, persistent=True)

    def assign_light(self, t: float, sim: Simulator,
                     waiting: List[tuple]) -> List[tuple]:
        store = sim.store
        alive = sim.alive_light_idx(t)
        store.refresh_y(alive, t)
        pools = {m: alive[store.m[alive] == m]
                 for m in {mm for _, mm in waiting}}
        still = []
        for tid, m in waiting:
            pa = pools[m]
            cand = pa[store.y_now[pa] < Y_FIXED] if len(pa) else pa
            if not len(cand):
                still.append((tid, m))
                continue
            # least-contended instance (GA fitness assumed balanced load)
            inst = int(cand[int(np.argmin(store.y_now[cand]))])
            sim.commit_light(sim.tasks[tid], m, inst, now=t)
            store.y_now[inst] += 1
        return still
