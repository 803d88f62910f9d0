"""Event-driven slot simulator for the paper's evaluation (Sec. IV).

Continuous-time event engine (heapq) for stage completions; control
decisions at 1 ms slot boundaries:

* core MS stages dispatch immediately on readiness to the min-finish-time
  instance (static placement fixed by the strategy);
* light MS stages queue and are assigned by the strategy's per-slot
  controller (Algorithm 1 for the proposal; RR / GA / mean-value for the
  baselines);
* light-service durations are *sampled* from the Gamma contention model —
  strategies only see their own estimates (effective-capacity or mean).

Costs follow eqs (6)-(7); metrics: completion rate, on-time rate, cost.

The hot paths are vectorized over flat numpy arrays (EXPERIMENTS.md
§Vectorized engine): arrivals are ONE Poisson draw per slot over the
users x task-type grid (`draw_arrivals`), light-instance state lives in
column arrays (`InstanceStore`) so aliveness / resource usage / cost
accrual are masked reductions, and data-readiness is evaluated for
whole candidate-node vectors at once via the affine routed-path tables
of `EdgeNetwork.prepare`.  `repro_torch.core.simulator_scalar` keeps the
fixed-semantics scalar reference engine that consumes the identical RNG
stream — tests/test_torch_simulator.py and chip_smoke.py's planning
phase check the two agree trial-for-trial.

The port's copy of ``repro/core/simulator.py`` (numpy only, line for
line), held against it on equal seeds by tests/test_torch_simulator.py.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import Application, TaskType
from repro_torch.core.network import EdgeNetwork

SLOT_MS = 1.0

# commit_light service sampling: blocks of ~3x the expected slot count
# are drawn until the cumulative service covers the workload; after this
# many blocks we raise — the pre-vectorization engine silently scheduled
# the task to finish early instead, shortening its true service time
MAX_SERVICE_BLOCKS = 1024


@dataclass(frozen=True)
class ChurnEvent:
    """A scheduled node state change: at slot `slot`, `node` fails or
    recovers.  Generalizes the old single (fail_node, fail_at) pair to
    multi-node failure/recovery schedules (scenario registry)."""
    slot: int
    node: int
    action: str                  # "fail" | "recover"

    def __post_init__(self):
        assert self.action in ("fail", "recover"), self.action


@dataclass
class Task:
    id: int
    tt: TaskType
    user: int
    t_gen: float
    ed: int                      # entry node
    # when the wireless uplink of the input payload completes; t_gen is
    # the generation instant (E2E latency reference).  Optional so
    # hand-built Tasks degrade to "payload present at t_gen".
    uplink_done: Optional[float] = None
    done: Dict[int, float] = field(default_factory=dict)   # ms -> finish t
    loc: Dict[int, int] = field(default_factory=dict)      # ms -> node
    dispatched: set = field(default_factory=set)
    finish: Optional[float] = None

    @property
    def deadline_abs(self) -> float:
        return self.t_gen + self.tt.deadline

    def ready_stages(self) -> List[int]:
        out = []
        for m in self.tt.ms_ids:
            if m in self.done or m in self.dispatched:
                continue
            if all(p in self.done for p in self.tt.parents(m)):
                out.append(m)
        return out

    def data_ready_at(self, m: int, net: EdgeNetwork, v: int) -> float:
        """When all of m's input data can be present on node v."""
        parents = self.tt.parents(m)
        if not parents:
            # input payload sits at the entry ED once the uplink has
            # finished (NOT at t_gen: the old code re-set t_gen to the
            # generation instant after construction, so source stages
            # saw their data one uplink too early); payload moves ED->v
            up = self.t_gen if self.uplink_done is None else self.uplink_done
            return up + net.path_ms(self.ed, v, self.tt.payload)
        t = 0.0
        for p in parents:
            tp = self.done[p] + net.path_ms(self.loc[p], v,
                                            self._b(p))
            t = max(t, tp)
        return t

    def data_ready_at_nodes(self, m: int, net: EdgeNetwork,
                            nodes: Optional[np.ndarray] = None
                            ) -> np.ndarray:
        """Vector of `data_ready_at(m, net, v)` over `nodes` (all nodes
        when omitted); elementwise identical to the scalar method."""
        def route_row(src: int, mb: float) -> np.ndarray:
            if nodes is None:
                return net.path_ms_row(src, mb)
            return (mb * net.path_invbw[src, nodes]
                    + net.path_prop[src, nodes])

        parents = self.tt.parents(m)
        if not parents:
            up = self.t_gen if self.uplink_done is None else self.uplink_done
            return up + route_row(self.ed, self.tt.payload)
        acc = None
        for p in parents:
            row = self.done[p] + route_row(self.loc[p], self._b(p))
            acc = row if acc is None else np.maximum(acc, row)
        return acc

    def _b(self, m):  # filled by simulator (app reference shortcut)
        return self._app.ms(m).b


# ----------------------------------------------------------------------
# Shared stochastic kernels (vectorized engine AND the scalar reference
# call these, so both consume the identical RNG stream)
# ----------------------------------------------------------------------
def draw_arrivals(rng: np.random.Generator, net: EdgeNetwork,
                  app: Application, t_slot: int, mult: float
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray]:
    """Batched per-slot arrival sampling: one Poisson draw over the
    users x task-type grid, one uniform batch of generation offsets,
    one fading batch of uplink delays.  Tasks are ordered (user-major,
    type-minor) to match the old nested-loop generation order."""
    rates = np.array([tt.rate for tt in app.task_types])
    lam = np.broadcast_to(rates * (mult * SLOT_MS),
                          (net.n_users, len(rates)))
    counts = rng.poisson(lam)
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0)
        return np.zeros(0, dtype=int), np.zeros(0, dtype=int), z, z
    u_idx = np.repeat(np.arange(net.n_users), counts.sum(axis=1))
    tt_idx = np.repeat(np.tile(np.arange(len(rates)), net.n_users),
                       counts.ravel())
    t_gen = t_slot + rng.uniform(0.0, SLOT_MS, size=total)
    payloads = np.array([tt.payload for tt in app.task_types])[tt_idx]
    uplink = net.sample_uplink_ms_batch(rng, u_idx, payloads)
    return u_idx, tt_idx, t_gen, uplink


def sample_service_ms(rng: np.random.Generator, ms, work: float) -> float:
    """True light-service duration from the paper's cumulative service
    process F(0,t) = sum_tau f_m(tau) with i.i.d. Gamma per-slot rates:
    the task (admitted at concurrency y_eff, so `work` = y_eff * a)
    completes in the first slot where the cumulative service reaches its
    scaled workload.  Blocks are drawn until the workload is covered —
    raising after MAX_SERVICE_BLOCKS rather than ever silently
    scheduling an early finish."""
    n_exp = max(4, int(3 * work / max(ms.f_mean, 1e-6)) + 4)
    dur = 0.0
    for _ in range(MAX_SERVICE_BLOCKS):
        f = np.maximum(rng.gamma(ms.f_shape, ms.f_scale, size=n_exp), 1e-6)
        cum = np.cumsum(f) * SLOT_MS
        if cum[-1] >= work:
            i = int(np.searchsorted(cum, work))
            prev = cum[i - 1] if i else 0.0
            return dur + i * SLOT_MS + (work - prev) / f[i]
        work -= cum[-1]
        dur += n_exp * SLOT_MS
    raise RuntimeError(
        f"cumulative Gamma service for MS {ms.name!r} did not cover the "
        f"workload after {MAX_SERVICE_BLOCKS} blocks of {n_exp} slots — "
        f"the service-rate parameters are degenerate for this workload")


class InstanceStore:
    """Flat column-array state for light-MS instances (replaces the
    per-object ``LightInstance`` list): node, service, birth, busy
    horizon and current-slot parallelism live in numpy arrays so
    aliveness, resource usage and cost accrual reduce over masks; the
    per-instance in-flight finish times stay as small pruned lists."""

    _COLS = ("v", "m", "born", "busy_until", "persistent", "y_now")

    def __init__(self, cap: int = 64):
        self.n = 0
        self.v = np.zeros(cap, dtype=np.int64)
        self.m = np.zeros(cap, dtype=np.int64)
        self.born = np.zeros(cap)
        self.busy_until = np.zeros(cap)
        self.persistent = np.zeros(cap, dtype=bool)
        self.y_now = np.zeros(cap, dtype=np.int64)
        self.active: List[List[float]] = []

    def _grow(self):
        cap = max(64, 2 * len(self.v))
        for name in self._COLS:
            arr = getattr(self, name)
            new = np.zeros(cap, dtype=arr.dtype)
            new[:self.n] = arr[:self.n]
            setattr(self, name, new)

    def spawn(self, v: int, m: int, born: float,
              persistent: bool = False) -> int:
        if self.n == len(self.v):
            self._grow()
        i = self.n
        self.v[i] = v
        self.m[i] = m
        self.born[i] = born
        self.busy_until[i] = 0.0
        self.persistent[i] = persistent
        self.y_now[i] = 0
        self.active.append([])
        self.n += 1
        return i

    def y_at(self, i: int, now: float) -> int:
        """Concurrent tasks on instance i at time `now` (prunes
        finished entries)."""
        lst = [f for f in self.active[i] if f > now]
        self.active[i] = lst
        return len(lst)

    def refresh_y(self, idx: np.ndarray, now: float) -> None:
        """Recompute y_now for the given instances at slot time."""
        for i in idx:
            self.y_now[i] = self.y_at(int(i), now)

    def alive_mask(self, now: float, dead_nodes) -> np.ndarray:
        """Alive = persistent, still busy, or spawned within the last
        slot — and not homed on a failed node."""
        n = self.n
        alive = (self.persistent[:n] | (self.busy_until[:n] > now)
                 | (self.born[:n] >= now - SLOT_MS))
        if dead_nodes:
            alive &= ~np.isin(self.v[:n], np.fromiter(
                dead_nodes, dtype=np.int64))
        return alive


class Simulator:
    def __init__(self, app: Application, net: EdgeNetwork, strategy,
                 rng: np.random.Generator, horizon_slots: int = 100,
                 drain_slots: int = 400, fail_node: Optional[int] = None,
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
        # fault-injection (validates the kappa diversity constraint C6):
        # a churn schedule of fail/recover events per node — a failed
        # node's core instances stop serving and no light instance can
        # be (re)placed there until (if ever) it recovers.  The legacy
        # (fail_node, fail_at) pair is folded into the schedule.
        events = list(churn or [])
        if fail_node is not None and fail_at is not None:
            events.append(ChurnEvent(slot=fail_at, node=fail_node,
                                     action="fail"))
        self._churn_by_slot: Dict[int, List[ChurnEvent]] = {}
        for ev in events:
            self._churn_by_slot.setdefault(ev.slot, []).append(ev)
        # per-slot multiplier on mean arrival rates (MMPP / diurnal
        # scenarios); called once per generation slot, in order
        self.arrival_modulation = arrival_modulation
        self.dead_nodes: set = set()
        self.tasks: Dict[int, Task] = {}
        self.events: list = []      # (time, seq, task_id, ms)
        self._seq = itertools.count()
        self._task_ids = itertools.count()
        self.waiting: List[tuple] = []   # (task_id, ms) light stages queued
        # core state
        self.x_cr: Dict[int, np.ndarray] = {}
        self.core_free: Dict[tuple, np.ndarray] = {}
        self._core_hosts: Dict[int, np.ndarray] = {}
        # light state
        self.store = InstanceStore()
        self.light_cost = 0.0
        self._prev_alive_counts: Optional[np.ndarray] = None
        # (M, K) stacked per-MS resource requirement rows
        self._r_stack = np.stack([ms.r for ms in app.services])
        # flat tid-indexed task ledgers for vectorized controllers and
        # metrics (mirrors the Task objects)
        cap = 256
        self.task_t_gen = np.zeros(cap)
        self.task_deadline = np.zeros(cap)
        self.task_finish = np.full(cap, np.nan)
        self.task_open = np.zeros(cap, dtype=bool)
        # metrics
        self.n_generated = 0

    # ------------------------------------------------------------------
    # Setup
    # ------------------------------------------------------------------
    def place_core(self):
        self.x_cr = self.strategy.place_core(self.app, self.net)
        for m, xv in self.x_cr.items():
            for v in range(self.net.n_nodes):
                if xv[v] > 0:
                    self.core_free[(v, m)] = np.zeros(int(xv[v]))
            self._core_hosts[m] = np.flatnonzero(np.asarray(xv) > 0)
        # capacity left for lights
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
    # Arrivals
    # ------------------------------------------------------------------
    def _ensure_task_cap(self, n: int):
        cap = len(self.task_t_gen)
        if n <= cap:
            return
        while cap < n:
            cap *= 2
        for name in ("task_t_gen", "task_deadline", "task_finish",
                     "task_open"):
            arr = getattr(self, name)
            fill = np.nan if name == "task_finish" else 0
            new = np.full(cap, fill, dtype=arr.dtype)
            new[:len(arr)] = arr
            setattr(self, name, new)

    def _generate(self, t_slot: int):
        mult = (self.arrival_modulation(t_slot)
                if self.arrival_modulation is not None else 1.0)
        u_idx, tt_idx, t_gen, uplink = draw_arrivals(
            self.rng, self.net, self.app, t_slot, mult)
        total = len(u_idx)
        if total == 0:
            return
        self._ensure_task_cap(len(self.tasks) + total)
        for k in range(total):
            tid = next(self._task_ids)
            tt = self.app.task_types[int(tt_idx[k])]
            task = Task(id=tid, tt=tt, user=int(u_idx[k]),
                        t_gen=float(t_gen[k]),
                        ed=int(self.net.user_ed[u_idx[k]]),
                        uplink_done=float(t_gen[k] + uplink[k]))
            task._app = self.app
            self.tasks[tid] = task
            self.task_t_gen[tid] = task.t_gen
            self.task_deadline[tid] = tt.deadline
            self.task_open[tid] = True
            self.n_generated += 1
            if hasattr(self.strategy, "admit"):
                self.strategy.admit(task)
            self._advance_task(task, now=task.uplink_done)

    # ------------------------------------------------------------------
    # DAG progression
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
        hosts = self._core_hosts.get(m)
        best = None
        if hosts is not None and len(hosts):
            ready_nodes = task.data_ready_at_nodes(m, self.net, hosts)
            proc = ms.a / ms.f_det
            for h in range(len(hosts)):
                v = int(hosts[h])
                if v in self.dead_nodes:
                    continue
                ready = max(float(ready_nodes[h]), now)
                free = self.core_free[(v, m)]
                i = int(np.argmin(free))
                start = max(ready, free[i])
                fin = start + proc
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

    def commit_light(self, task: Task, m: int, inst: int, now: float):
        """Strategy decided: run stage m of task on store instance
        index `inst`; samples the true Gamma service duration."""
        ms = self.app.ms(m)
        store = self.store
        v = int(store.v[inst])
        ready = max(task.data_ready_at(m, self.net, v), now)
        y_eff = store.y_at(inst, ready) + 1
        dur = sample_service_ms(self.rng, ms, ms.a * y_eff)
        fin = ready + dur
        store.busy_until[inst] = max(store.busy_until[inst], fin)
        store.active[inst].append(fin)
        heapq.heappush(self.events,
                       (fin, next(self._seq), task.id, m, v))

    def spawn_instance(self, v: int, m: int, now: float,
                       persistent: bool = False) -> int:
        assert v not in self.dead_nodes, "cannot place on a failed node"
        return self.store.spawn(v, m, now, persistent)

    # ------------------------------------------------------------------
    # Per-slot accounting
    # ------------------------------------------------------------------
    def alive_light_idx(self, now: float) -> np.ndarray:
        """Indices of alive light instances, in spawn order."""
        return np.flatnonzero(self.store.alive_mask(now, self.dead_nodes))

    def light_resources_used(self, now: float) -> np.ndarray:
        used = np.zeros_like(self.net.R)
        idx = self.alive_light_idx(now)
        if len(idx):
            np.add.at(used, self.store.v[idx],
                      self._r_stack[self.store.m[idx]])
        return used

    def _accrue_light_cost(self, t: float):
        idx = self.alive_light_idx(t)
        n_ms = len(self.app.services)
        counts = np.bincount(self.store.v[idx] * n_ms + self.store.m[idx],
                             minlength=self.net.n_nodes * n_ms)
        prev = self._prev_alive_counts
        if prev is None:
            prev = np.zeros_like(counts)
        # iterate occupied (v, m) cells in sorted order (the scalar
        # reference iterates sorted too, so the float accumulation
        # order — hence the cost bits — matches exactly)
        for k in np.flatnonzero(counts):
            m = int(k) % n_ms
            ms = self.app.ms(m)
            c = int(counts[k])
            newly = max(0, c - int(prev[k]))
            self.light_cost += ms.c_dp * newly + (ms.c_mt + ms.c_pl) * c
        self._prev_alive_counts = counts

    # ------------------------------------------------------------------
    # Main loop
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
            # controller at slot boundary
            if self.waiting:
                still = self.strategy.assign_light(float(t_slot), self,
                                                   self.waiting)
                self.waiting = still
            self._accrue_light_cost(float(t_slot))
            # drain events due this slot
            while self.events and self.events[0][0] < t_slot + 1:
                fin, _, tid, m, v = heapq.heappop(self.events)
                task = self.tasks[tid]
                task.done[m] = fin
                task.loc[m] = v
                if m == task.tt.sink():
                    task.finish = fin
                    self.task_finish[tid] = fin
                    self.task_open[tid] = False
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
        n_tasks = len(self.tasks)
        finish = self.task_finish[:n_tasks]
        t_gen = self.task_t_gen[:n_tasks]
        fin_mask = ~np.isnan(finish)
        lat = finish[fin_mask] - t_gen[fin_mask]
        on_time = int((lat <= self.task_deadline[:n_tasks][fin_mask]).sum())
        n = max(self.n_generated, 1)
        return {
            "strategy": getattr(self.strategy, "name", "?"),
            "generated": self.n_generated,
            "completed": int(fin_mask.sum()) / n,
            "on_time": on_time / n,
            "core_cost": self.core_cost(),
            "light_cost": self.light_cost,
            "total_cost": self.core_cost() + self.light_cost,
            "mean_latency_ms": float(np.mean(lat)) if len(lat)
            else float("nan"),
            "p95_latency_ms": float(np.percentile(lat, 95)) if len(lat)
            else float("nan"),
        }
