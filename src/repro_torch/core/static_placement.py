"""Static core-MS placement: the sparsity-constrained integer program
(eq. 14 with diversity constraints C4–C6 of eq. 16).

    min_x  sum_{v,m} x_{v,m} (c_m - xi * Q_{v,m})
    C1: r_{m,k} x_{v,m} <= R_{v,k}            (per-(v,m) box bound)
    C2: sum_v x_{v,m} >= sum_v z~_{v,m}       (global demand cover)
    C3: x integer >= 0
    C4/C5: x_{v,m} in {0} U [C3_MIN, C2_BIG]  (open-site band)
    C6: #open sites >= kappa                  (diversity)

Structure: the objective and C1/C2 decompose per MS m; only C6 couples.
Solver: per-m exact greedy (sort sites by net coefficient; negative-cost
sites are filled to their box bound, then demand is covered at cheapest
cost), then a diversity repair pass opens the cheapest additional sites
until C6 holds.  `brute_force` cross-checks optimality on small instances
(see tests/test_static_placement.py).

The port's copy of ``repro/core/static_placement.py`` (numpy only, line for line),
held against it on equal seeds by tests/test_torch_planning.py.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

C3_MIN = 1        # C5: minimum instances on an open site
XI_DEFAULT = 0.1  # cost-vs-QoS weight xi


@dataclass
class PlacementProblem:
    cost: Dict[int, float]          # c_m = c_dp + c_mt per core MS
    q: Dict[int, np.ndarray]        # Q_{v,m}
    z: Dict[int, np.ndarray]        # z~_{v,m}
    box: Dict[int, np.ndarray]      # per-(v,m) max instances from C1
    kappa: int = 0
    xi: float = XI_DEFAULT

    @property
    def core_ids(self):
        return sorted(self.cost)

    def net_coeff(self, m: int) -> np.ndarray:
        return self.cost[m] - self.xi * self.q[m]

    def demand(self, m: int) -> int:
        return int(np.ceil(self.z[m].sum()))

    def objective(self, x: Dict[int, np.ndarray]) -> float:
        return float(sum((self.net_coeff(m) * x[m]).sum()
                         for m in self.core_ids))

    def open_sites(self, x: Dict[int, np.ndarray]) -> int:
        return int(sum((x[m] > 0).sum() for m in self.core_ids))

    def feasible(self, x: Dict[int, np.ndarray]) -> bool:
        for m in self.core_ids:
            if (x[m] > self.box[m]).any() or (x[m] < 0).any():
                return False
            if x[m].sum() < self.demand(m):
                return False
        return self.open_sites(x) >= self.kappa


#: bf16 weight bytes — the baseline service sizes are calibrated to it
DENSE_BYTES_PER_PARAM = 2.0
#: Table-I resource columns that scale with the weight footprint
_MEM_DIMS = (1, 3)   # ram, vram (network.RESOURCE_NAMES)


def build_problem(app, net, z_tilde, q_score, kappa: int,
                  xi: float = XI_DEFAULT, horizon_slots: int = 1,
                  bytes_per_param: Optional[float] = None
                  ) -> PlacementProblem:
    """``bytes_per_param`` rescales the memory dimensions (RAM/VRAM) of
    every *core* service's demand vector by ``bytes_per_param / 2.0``
    before the C1 box is computed — the placement view of weight-only
    quantization (SERVING.md §Quantization): int8 halves and int4
    quarters the resident weight bytes, so each site's box bound admits
    proportionally more instances.  Compute dims and light services are
    untouched (dequant happens inside the matmul; FLOPs are unchanged)."""
    mem_scale = (1.0 if bytes_per_param is None
                 else bytes_per_param / DENSE_BYTES_PER_PARAM)
    cost, box = {}, {}
    for m in app.core_ids:
        ms = app.ms(m)
        cost[m] = ms.c_dp + ms.c_mt * horizon_slots
        r = np.asarray(ms.r, dtype=float).copy()
        if mem_scale != 1.0:
            for k in _MEM_DIMS:
                if k < r.shape[-1]:
                    r[..., k] *= mem_scale
        # C1 box: r_{m,k} * x <= R_{v,k}  ->  x <= min_k floor(R/r)
        with np.errstate(divide="ignore"):
            per_k = np.floor(net.R / np.maximum(r, 1e-9))
        box[m] = per_k.min(axis=1).astype(int)
    return PlacementProblem(cost=cost, q=q_score, z=z_tilde, box=box,
                            kappa=kappa, xi=xi)


# ----------------------------------------------------------------------
# Exact decomposed solver
# ----------------------------------------------------------------------
def solve(problem: PlacementProblem) -> Dict[int, np.ndarray]:
    x = {}
    for m in problem.core_ids:
        coeff = problem.net_coeff(m)
        cap = problem.box[m].copy()
        xm = np.zeros_like(cap)
        # 1) negative net cost -> profitable: fill to the box bound
        neg = coeff < 0
        xm[neg] = cap[neg]
        # 2) cover remaining demand at the cheapest positive sites
        need = problem.demand(m) - xm.sum()
        if need > 0:
            order = np.argsort(coeff)
            for v in order:
                if need <= 0:
                    break
                if xm[v] >= cap[v]:
                    continue
                take = min(cap[v] - xm[v], need)
                if take >= C3_MIN or xm[v] > 0:
                    xm[v] += take
                    need -= take
        x[m] = xm

    # 3) diversity repair (C6): either open a fresh site (add C3_MIN
    # instances) or *move* an instance from the most expensive open donor
    # site (keeps demand covered, often cheaper) — whichever is cheaper.
    def best_repair():
        cands = []
        for m in problem.core_ids:
            coeff = problem.net_coeff(m)
            donors = [(coeff[v], v) for v in range(len(coeff))
                      if x[m][v] > max(C3_MIN, problem.demand(m) and 0)]
            surplus = x[m].sum() - problem.demand(m)
            for v in range(len(coeff)):
                if x[m][v] != 0 or problem.box[m][v] < C3_MIN:
                    continue
                open_cost = coeff[v] * C3_MIN
                cands.append((open_cost, m, v, None))
                # move: take one instance away from the priciest donor
                movable = [(c, dv) for c, dv in donors if x[m][dv] > C3_MIN]
                if surplus > 0:
                    # surplus instance can simply be deleted on add
                    movable += [(c, dv) for c, dv in donors]
                if movable and C3_MIN == 1:
                    dcost, dv = max(movable)
                    cands.append((coeff[v] - dcost, m, v, dv))
        return sorted(cands, key=lambda c: c[0])

    while problem.open_sites(x) < problem.kappa:
        cands = best_repair()
        if not cands:
            break  # infeasible kappa; return best effort
        _, m, v, donor = cands[0]
        x[m][v] = C3_MIN
        if donor is not None:
            x[m][donor] -= 1
    return x


# ----------------------------------------------------------------------
# Brute force (tests only)
# ----------------------------------------------------------------------
def brute_force(problem: PlacementProblem,
                max_inst: int = 3) -> Optional[Dict[int, np.ndarray]]:
    """Exhaustive search over small instances for solver cross-checks."""
    core = problem.core_ids
    v_n = len(problem.box[core[0]])
    best, best_obj = None, np.inf
    ranges = []
    for m in core:
        per_site = [range(0, min(int(problem.box[m][v]), max_inst) + 1)
                    for v in range(v_n)]
        ranges.append(list(itertools.product(*per_site)))
    for combo in itertools.product(*ranges):
        x = {m: np.array(combo[i]) for i, m in enumerate(core)}
        if not problem.feasible(x):
            continue
        obj = problem.objective(x)
        if obj < best_obj - 1e-12:
            best, best_obj = x, obj
    return best
