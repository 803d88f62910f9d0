"""Fixed-semantics SCALAR reference engine for the vectorized simulator.

This module preserves the pre-vectorization, per-object/per-task pure
Python evaluation loop — with the same *semantics fixes* the vectorized
engine carries (uplink-gated source readiness, no silent service
truncation) and the same RNG draw layout (the shared batched kernels in
`repro_torch.core.simulator`), so a `ScalarSimulator` trial consumes exactly
the RNG stream of a vectorized `Simulator` trial and must reproduce its
metrics bit-for-bit.  chip_smoke.py's planning phase asserts that
equality trial-for-trial and reports both engines' wall seconds;
tests/test_torch_simulator.py locks it.

Nothing here should grow features: it exists as the semantic oracle and
the speedup baseline.  New work goes into `repro_torch.core.simulator`.

The port's copy of ``repro/core/simulator_scalar.py`` (numpy only, line
for line), held against it on equal seeds by
tests/test_torch_simulator.py.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.lyapunov import ZETA, VirtualQueues
from repro_torch.core.simulator import (SLOT_MS, ChurnEvent, Task,
                                        draw_arrivals, sample_service_ms)


@dataclass
class LightInstance:
    id: int
    v: int
    m: int
    born: float
    busy_until: float = 0.0
    y_now: int = 0                                   # assigned this slot
    persistent: bool = False                         # static allocation
    active: List[float] = field(default_factory=list)  # finish times

    def y_at(self, now: float) -> int:
        """Concurrent tasks on this instance at time `now`."""
        self.active = [f for f in self.active if f > now]
        return len(self.active)


class ScalarSimulator:
    """The pre-vectorization event engine: per-task nested loops,
    per-object light-instance list, per-(pair) routed-path lookups."""

    def __init__(self, app, net, strategy, rng: np.random.Generator,
                 horizon_slots: int = 100, drain_slots: int = 400,
                 fail_node: Optional[int] = None,
                 fail_at: Optional[int] = None,
                 churn: Optional[Sequence[ChurnEvent]] = None,
                 arrival_modulation: Optional[
                     Callable[[int], float]] = None):
        self.app = app
        self.net = net
        self.strategy = strategy
        self.rng = rng
        self.horizon = horizon_slots
        self.drain = drain_slots
        events = list(churn or [])
        if fail_node is not None and fail_at is not None:
            events.append(ChurnEvent(slot=fail_at, node=fail_node,
                                     action="fail"))
        self._churn_by_slot: Dict[int, List[ChurnEvent]] = {}
        for ev in events:
            self._churn_by_slot.setdefault(ev.slot, []).append(ev)
        self.arrival_modulation = arrival_modulation
        self.dead_nodes: set = set()
        self.tasks: Dict[int, Task] = {}
        self.events: list = []      # (time, seq, task_id, ms)
        self._seq = itertools.count()
        self._task_ids = itertools.count()
        self.waiting: List[tuple] = []   # (task_id, ms) light stages queued
        self.x_cr: Dict[int, np.ndarray] = {}
        self.core_free: Dict[tuple, np.ndarray] = {}
        self.instances: List[LightInstance] = []
        self._inst_ids = itertools.count()
        self.light_cost = 0.0
        self.prev_alive: Dict[tuple, int] = {}
        self.n_generated = 0

    # ------------------------------------------------------------------
    def place_core(self):
        self.x_cr = self.strategy.place_core(self.app, self.net)
        for m, xv in self.x_cr.items():
            for v in range(self.net.n_nodes):
                if xv[v] > 0:
                    self.core_free[(v, m)] = np.zeros(int(xv[v]))
        used = np.zeros_like(self.net.R)
        for m, xv in self.x_cr.items():
            used += xv[:, None] * self.app.ms(m).r[None, :]
        self.R_lt = self.net.R - used

    def core_cost(self) -> float:
        total = 0.0
        for m, xv in self.x_cr.items():
            ms = self.app.ms(m)
            total += (ms.c_dp + ms.c_mt * self.horizon) * xv.sum()
        return float(total)

    # ------------------------------------------------------------------
    def _generate(self, t_slot: int):
        mult = (self.arrival_modulation(t_slot)
                if self.arrival_modulation is not None else 1.0)
        # identical batched draws as the vectorized engine, consumed by
        # the old per-task construction loop
        u_idx, tt_idx, t_gen, uplink = draw_arrivals(
            self.rng, self.net, self.app, t_slot, mult)
        for k in range(len(u_idx)):
            tid = next(self._task_ids)
            tt = self.app.task_types[int(tt_idx[k])]
            task = Task(id=tid, tt=tt, user=int(u_idx[k]),
                        t_gen=float(t_gen[k]),
                        ed=int(self.net.user_ed[u_idx[k]]),
                        uplink_done=float(t_gen[k] + uplink[k]))
            task._app = self.app
            self.tasks[tid] = task
            self.n_generated += 1
            if hasattr(self.strategy, "admit"):
                self.strategy.admit(task)
            self._advance_task(task, now=task.uplink_done)

    # ------------------------------------------------------------------
    def _advance_task(self, task: Task, now: float):
        for m in task.ready_stages():
            if self.app.ms(m).is_core:
                self._dispatch_core(task, m, now)
            else:
                task.dispatched.add(m)
                self.waiting.append((task.id, m))

    def _dispatch_core(self, task: Task, m: int, now: float):
        ms = self.app.ms(m)
        best = None
        for (v, mm), free in self.core_free.items():
            if mm != m or v in self.dead_nodes:
                continue
            ready = max(task.data_ready_at(m, self.net, v), now)
            i = int(np.argmin(free))
            start = max(ready, free[i])
            fin = start + ms.a / ms.f_det
            if best is None or fin < best[0]:
                best = (fin, v, i)
        if best is None:   # no instance anywhere: task cannot complete
            task.dispatched.add(m)
            return
        fin, v, i = best
        self.core_free[(v, m)][i] = fin
        task.dispatched.add(m)
        heapq.heappush(self.events,
                       (fin, next(self._seq), task.id, m, v))

    def commit_light(self, task: Task, m: int, inst: LightInstance,
                     now: float):
        ms = self.app.ms(m)
        ready = max(task.data_ready_at(m, self.net, inst.v), now)
        y_eff = inst.y_at(ready) + 1
        dur = sample_service_ms(self.rng, ms, ms.a * y_eff)
        fin = ready + dur
        inst.busy_until = max(inst.busy_until, fin)
        inst.active.append(fin)
        heapq.heappush(self.events,
                       (fin, next(self._seq), task.id, m, inst.v))

    def spawn_instance(self, v: int, m: int, now: float,
                       persistent: bool = False) -> LightInstance:
        assert v not in self.dead_nodes, "cannot place on a failed node"
        inst = LightInstance(id=next(self._inst_ids), v=v, m=m, born=now,
                             persistent=persistent)
        self.instances.append(inst)
        return inst

    # ------------------------------------------------------------------
    def alive_instances(self, now: float) -> List[LightInstance]:
        return [i for i in self.instances
                if i.v not in self.dead_nodes
                and (i.persistent or i.busy_until > now
                     or i.born >= now - SLOT_MS)]

    def light_resources_used(self, now: float) -> np.ndarray:
        used = np.zeros_like(self.net.R)
        for inst in self.alive_instances(now):
            used[inst.v] += self.app.ms(inst.m).r
        return used

    def _accrue_light_cost(self, t: float):
        alive = self.alive_instances(t)
        counts: Dict[tuple, int] = {}
        for inst in alive:
            counts[(inst.v, inst.m)] = counts.get((inst.v, inst.m), 0) + 1
        # sorted (v, m) iteration: the float accumulation order matches
        # the vectorized engine's bincount scan exactly
        for (v, m) in sorted(counts):
            c = counts[(v, m)]
            ms = self.app.ms(m)
            newly = max(0, c - self.prev_alive.get((v, m), 0))
            self.light_cost += ms.c_dp * newly + (ms.c_mt + ms.c_pl) * c
        self.prev_alive = counts

    # ------------------------------------------------------------------
    def run(self) -> dict:
        self.place_core()
        if hasattr(self.strategy, "init_light"):
            self.strategy.init_light(self)
        t_end = self.horizon + self.drain
        for t_slot in range(t_end):
            for ev in self._churn_by_slot.get(t_slot, ()):
                if ev.action == "fail":
                    self.dead_nodes.add(ev.node)
                else:
                    self.dead_nodes.discard(ev.node)
            if t_slot < self.horizon:
                self._generate(t_slot)
            if self.waiting:
                still = self.strategy.assign_light(float(t_slot), self,
                                                   self.waiting)
                self.waiting = still
            self._accrue_light_cost(float(t_slot))
            while self.events and self.events[0][0] < t_slot + 1:
                fin, _, tid, m, v = heapq.heappop(self.events)
                task = self.tasks[tid]
                task.done[m] = fin
                task.loc[m] = v
                if m == task.tt.sink():
                    task.finish = fin
                    if hasattr(self.strategy, "task_done"):
                        self.strategy.task_done(task)
                else:
                    self._advance_task(task, now=fin)
            if hasattr(self.strategy, "end_slot"):
                self.strategy.end_slot(float(t_slot), self)
            if (t_slot >= self.horizon and not self.events
                    and not self.waiting):
                break
        return self.metrics()

    def metrics(self) -> dict:
        fin = [t for t in self.tasks.values() if t.finish is not None]
        on_time = [t for t in fin
                   if t.finish - t.t_gen <= t.tt.deadline]
        n = max(self.n_generated, 1)
        lat = [t.finish - t.t_gen for t in fin]
        return {
            "strategy": getattr(self.strategy, "name", "?"),
            "generated": self.n_generated,
            "completed": len(fin) / n,
            "on_time": len(on_time) / n,
            "core_cost": self.core_cost(),
            "light_cost": self.light_cost,
            "total_cost": self.core_cost() + self.light_cost,
            "mean_latency_ms": float(np.mean(lat)) if lat else float("nan"),
            "p95_latency_ms": float(np.percentile(lat, 95)) if lat
            else float("nan"),
        }


# ----------------------------------------------------------------------
# Scalar strategy counterparts (pre-vectorization control loops over the
# object-based instance API; decisions match the vectorized strategies)
# ----------------------------------------------------------------------
from repro_torch.core.baselines import (GAStrategy, LBRRStrategy,  # noqa: E402
                                        Y_FIXED)
from repro_torch.core.online_controller import (Y_MAX,  # noqa: E402
                                                ProposalStrategy)


class ScalarProposalStrategy(ProposalStrategy):
    """Algorithm 1 as the pre-PR quadruple Python loop."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.queues = VirtualQueues(zeta=ZETA)

    def end_slot(self, t: float, sim):
        for tid, task in sim.tasks.items():
            if task.finish is None:
                self.queues.update(tid, (t + 1) - task.t_gen,
                                   task.tt.deadline)

    def _estimate(self, m: int, y: int) -> float:
        ec = self.ec[m]
        return ec.g_mean(y) if self.use_mean_estimate else ec.g(y)

    def _dt(self, sim, task, m, v, y, now) -> float:
        arrive = task.data_ready_at(m, sim.net, v)
        return max(0.0, arrive - now) + self._estimate(m, y)

    def assign_light(self, t: float, sim, waiting):
        app, net = sim.app, sim.net
        waiting = [(tid, m) for tid, m in waiting]
        if not waiting:
            return []

        live = {i.id: i for i in sim.alive_instances(t)}
        for i in live.values():
            i.y_now = i.y_at(t)
        free_r = net.R - sim.light_resources_used(t)
        for m, xv in sim.x_cr.items():
            free_r -= xv[:, None] * app.ms(m).r[None, :]
        free_r = np.maximum(free_r, 0.0)

        new_instances: List = []

        def feasible(v, m):
            if v in sim.dead_nodes:
                return False
            return bool((free_r[v] >= app.ms(m).r).all())

        def candidates(ms_needed):
            # sorted: canonical stage order shared with the vectorized
            # controller (the pre-PR set iteration order was arbitrary)
            return [(v, m) for m in sorted(ms_needed)
                    for v in range(net.n_nodes) if feasible(v, m)]

        while True:
            ms_needed = {m for _, m in waiting}
            best = (0.0, None, None)
            for v, m in candidates(ms_needed):
                ms = app.ms(m)
                cost_new = self.eta * (ms.c_dp + ms.c_mt + ms.c_pl)
                gain = 0.0
                y_hyp = 0
                for tid, mm in waiting:
                    if mm != m:
                        continue
                    task = sim.tasks[tid]
                    dt_new = self._dt(sim, task, m, v, y_hyp + 1, t)
                    defer = SLOT_MS + self._estimate(m, 1)
                    for inst in live.values():
                        if inst.m == m:
                            defer = min(defer, self._dt(
                                sim, task, m, inst.v, inst.y_now + 1, t))
                    for inst in new_instances:
                        if inst.m == m:
                            defer = min(defer, self._dt(
                                sim, task, m, inst.v, inst.y_now + 1, t))
                    if dt_new < defer:
                        h = self.queues.get(tid)
                        gain += self.phi * h * (defer - dt_new)
                        y_hyp += 1
                dl = cost_new - gain
                if dl < best[0]:
                    best = (dl, v, m)
            if best[1] is None:
                break
            _, v, m = best
            inst = sim.spawn_instance(v, m, t)
            new_instances.append(inst)
            free_r[v] -= app.ms(m).r

        pool = list(live.values()) + new_instances
        still = []
        order = sorted(waiting,
                       key=lambda wm: -self.queues.get(wm[0]))
        for tid, m in order:
            task = sim.tasks[tid]
            opts = [i for i in pool if i.m == m and i.y_now < Y_MAX]
            if not opts:
                still.append((tid, m))
                continue
            dts = [self._dt(sim, task, m, i.v, i.y_now + 1, t)
                   for i in opts]
            k = int(np.argmin(dts))
            inst = opts[k]
            sim.commit_light(task, m, inst, now=t)
            inst.y_now += 1
        return still


class ScalarPropAvgStrategy(ScalarProposalStrategy):
    name = "prop_avg"
    use_mean_estimate = True


class ScalarLBRRStrategy(LBRRStrategy):
    def assign_light(self, t: float, sim, waiting):
        live = list(sim.alive_instances(t))
        for i in live:
            i.y_now = i.y_at(t)
        still = []
        for tid, m in waiting:
            task = sim.tasks[tid]
            opts = [i for i in live if i.m == m and i.y_now < Y_FIXED]
            if not opts:
                still.append((tid, m))
                continue
            inst = opts[self._rr % len(opts)]
            self._rr += 1
            sim.commit_light(task, m, inst, now=t)
            inst.y_now += 1
        return still


class ScalarGAStrategy(GAStrategy):
    def assign_light(self, t: float, sim, waiting):
        live = list(sim.alive_instances(t))
        for i in live:
            i.y_now = i.y_at(t)
        still = []
        for tid, m in waiting:
            task = sim.tasks[tid]
            opts = [i for i in live if i.m == m and i.y_now < Y_FIXED]
            if not opts:
                still.append((tid, m))
                continue
            inst = min(opts, key=lambda i: i.y_now)
            sim.commit_light(task, m, inst, now=t)
            inst.y_now += 1
        return still


SCALAR_STRATEGIES = {
    "proposal": ScalarProposalStrategy,
    "prop_avg": ScalarPropAvgStrategy,
    "lbrr": ScalarLBRRStrategy,
    "ga": ScalarGAStrategy,
}


def build_scalar_strategy(name: str, horizon_slots: int = 100,
                          eps: float = 0.2, kappa=None, seed: int = 0,
                          bytes_per_param=None):
    """Scalar counterpart of `repro_torch.core.experiment.build_strategy`."""
    cls = SCALAR_STRATEGIES[name]
    if name in ("proposal", "prop_avg"):
        kw = {"horizon_slots": horizon_slots, "eps": eps}
        if kappa is not None:
            kw["kappa"] = kappa
        if bytes_per_param is not None:
            kw["bytes_per_param"] = bytes_per_param
        return cls(**kw)
    if name == "ga":
        return cls(seed=seed)
    return cls()


def run_one_scalar(spec) -> dict:
    """`repro_torch.experiments.runner.run_one`, but on the scalar reference
    engine — same environment streams, same spec annotation."""
    from repro_torch.core.experiment import spawn_rng, stable_seed
    from repro_torch.experiments.scenarios import get_scenario

    scen = get_scenario(spec.scenario)
    sid = stable_seed(spec.scenario)
    env_rng = spawn_rng(spec.seed, sid, 0)
    app = scen.build_application(env_rng,
                                 rate_multiplier=spec.rate_multiplier)
    net = scen.build_network(env_rng)
    churn = scen.churn_schedule(net, spawn_rng(spec.seed, sid, 1),
                                spec.horizon_slots)
    modulation = scen.arrival_modulation(spawn_rng(spec.seed, sid, 2))
    strat = build_scalar_strategy(
        spec.strategy, horizon_slots=spec.horizon_slots, eps=spec.eps,
        kappa=spec.kappa, seed=spec.seed,
        bytes_per_param=getattr(spec, "bytes_per_param", None))
    sim = ScalarSimulator(app, net, strat,
                          rng=spawn_rng(spec.seed, sid,
                                        stable_seed(spec.strategy)),
                          horizon_slots=spec.horizon_slots,
                          drain_slots=getattr(spec, "drain_slots", 400),
                          churn=churn, arrival_modulation=modulation)
    m = sim.run()
    m.update(seed=spec.seed, scenario=spec.scenario,
             rate_multiplier=spec.rate_multiplier,
             horizon_slots=spec.horizon_slots,
             drain_slots=getattr(spec, "drain_slots", 400), eps=spec.eps,
             kappa=spec.kappa,
             bytes_per_param=getattr(spec, "bytes_per_param", None))
    return m
