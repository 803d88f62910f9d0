"""Microservice + task-DAG application model (Fig. 1 of the paper).

Task graphs are *inverse trees*: each node has any number of incoming edges
but at most one outgoing edge (multimodal fusion funnels into one output).

The port's copy of ``repro/core/graph.py`` (numpy only, line for line),
held against it on equal seeds by tests/test_torch_planning.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import paper_params as pp


@dataclass
class Microservice:
    idx: int
    name: str
    kind: str                      # "core" | "light"
    r: np.ndarray                  # (K,) resource requirement
    a: float                       # workload MB per task
    b: float                       # output MB
    # core: deterministic rate; light: Gamma(shape, scale) contention model
    f_det: float = 0.0
    f_shape: float = 0.0
    f_scale: float = 0.0
    c_dp: float = 0.0
    c_mt: float = 0.0
    c_pl: float = 0.0

    @property
    def is_core(self) -> bool:
        return self.kind == "core"

    @property
    def f_mean(self) -> float:
        return self.f_det if self.is_core else self.f_shape * self.f_scale

    def mean_proc_ms(self) -> float:
        return self.a / max(self.f_mean, 1e-9)


@dataclass
class TaskType:
    idx: int
    name: str
    ms_ids: List[int]              # all MSs used, topological order
    edges: List[Tuple[int, int]]   # (src_ms, dst_ms) data dependencies
    deadline: float = 0.0          # D_n ms
    payload: float = 0.0           # A_n MB
    rate: float = 0.0              # mean Poisson arrivals per user per ms

    def parents(self, m: int) -> List[int]:
        return [s for s, d in self.edges if d == m]

    def children(self, m: int) -> List[int]:
        return [d for s, d in self.edges if s == m]

    def sources(self) -> List[int]:
        dst = {d for _, d in self.edges}
        return [m for m in self.ms_ids if m not in dst] or self.ms_ids[:1]

    def sink(self) -> int:
        src = {s for s, _ in self.edges}
        sinks = [m for m in self.ms_ids if m not in src]
        assert len(sinks) == 1, "inverse tree must have a single sink"
        return sinks[0]

    def descendants(self, m: int) -> List[int]:
        """All MSs strictly downstream of m (unique path to sink)."""
        out = []
        cur = m
        while True:
            ch = self.children(cur)
            if not ch:
                return out
            assert len(ch) <= 1, "inverse tree: at most one outgoing edge"
            cur = ch[0]
            out.append(cur)

    def validate_inverse_tree(self) -> bool:
        return all(len(self.children(m)) <= 1 for m in self.ms_ids)


@dataclass
class Application:
    services: List[Microservice]
    task_types: List[TaskType]

    @property
    def core_ids(self) -> List[int]:
        return [m.idx for m in self.services if m.is_core]

    @property
    def light_ids(self) -> List[int]:
        return [m.idx for m in self.services if not m.is_core]

    def ms(self, idx: int) -> Microservice:
        return self.services[idx]

    def types_using(self, m: int) -> List[TaskType]:
        return [tt for tt in self.task_types if m in tt.ms_ids]


# ----------------------------------------------------------------------
# Paper evaluation instance: 4 task types, 6 core MSs, 9 light MSs
# ----------------------------------------------------------------------
def _sample_ms(rng, idx, name, kind) -> Microservice:
    spec = pp.TABLE_I["core_ms" if kind == "core" else "light_ms"]
    r = np.array([rng.uniform(lo, hi) for lo, hi in spec["r"]])
    ms = Microservice(
        idx=idx, name=name, kind=kind, r=r,
        a=rng.uniform(*spec["a"]), b=rng.uniform(*spec["b"]),
        c_dp=spec["c_dp"], c_mt=spec["c_mt"], c_pl=spec["c_pl"])
    if kind == "core":
        ms.f_det = rng.uniform(*spec["f"])
    else:
        ms.f_shape = rng.uniform(*spec["f_gamma_shape"])
        ms.f_scale = rng.uniform(*spec["f_gamma_scale"])
    return ms


# Fig.-1-style inverse-tree templates over core ids C0..C5 (global idx 0..5)
# and light ids L0..L8 (global idx 6..14).  Squares=cores, circles=lights.
_DAG_TEMPLATES = [
    # type 0: AR pipeline — two modality branches fuse into a core
    # L0->C0 ; L1->C1 ; {C0,C1}->L2 ; L2->C2 ; C2->L3
    (["L0", "C0", "L1", "C1", "L2", "C2", "L3"],
     [("L0", "C0"), ("L1", "C1"), ("C0", "L2"), ("C1", "L2"),
      ("L2", "C2"), ("C2", "L3")]),
    # type 1: generation — pre, heavy chain, post
    # L4->C3 ; C3->L5 ; L5->C4 ; C4->L6
    (["L4", "C3", "L5", "C4", "L6"],
     [("L4", "C3"), ("C3", "L5"), ("L5", "C4"), ("C4", "L6")]),
    # type 2: three-branch fusion
    # L0->C0 ; L7->C5 ; L8->{merge at L2'}: {C0,C5,L1}->L5'->C2->L3
    (["L0", "C0", "L7", "C5", "L1", "L8", "C2", "L3"],
     [("L0", "C0"), ("L7", "C5"), ("C0", "L8"), ("C5", "L8"),
      ("L1", "L8"), ("L8", "C2"), ("C2", "L3")]),
    # type 3: perception — conv core then fuse with retrieval core
    # L4->C1 ; L7->C3 ; {C1,C3}->L6' ; L6'->C4 ; C4->L5'
    (["L4", "C1", "L7", "C3", "L2", "C4", "L6"],
     [("L4", "C1"), ("L7", "C3"), ("C1", "L2"), ("C3", "L2"),
      ("L2", "C4"), ("C4", "L6")]),
]


def make_application(rng: np.random.Generator,
                     rate_multiplier: float = 1.0,
                     type_rate_multipliers: Optional[Sequence[float]] = None,
                     deadline_multiplier: float = 1.0) -> Application:
    """Sample a paper-scale application instance from Table I ranges.

    `type_rate_multipliers` skews arrival rates per task type (scenario
    registry: skewed-workload mixes) on top of the global
    `rate_multiplier`; `deadline_multiplier` uniformly tightens or
    relaxes deadlines.  Sampling order is fixed, so the same rng seed
    yields the same base instance regardless of the multipliers.
    """
    if type_rate_multipliers is not None:
        assert len(type_rate_multipliers) == len(_DAG_TEMPLATES), \
            "one multiplier per task type"
    services = []
    for i in range(pp.N_CORE_MS):
        services.append(_sample_ms(rng, i, f"C{i}", "core"))
    for i in range(pp.N_LIGHT_MS):
        services.append(_sample_ms(rng, pp.N_CORE_MS + i, f"L{i}", "light"))
    name_to_idx = {ms.name: ms.idx for ms in services}

    task_types = []
    for n, (nodes, edges) in enumerate(_DAG_TEMPLATES):
        type_mult = (type_rate_multipliers[n]
                     if type_rate_multipliers is not None else 1.0)
        tt = TaskType(
            idx=n, name=f"type{n}",
            ms_ids=[name_to_idx[x] for x in nodes],
            edges=[(name_to_idx[s], name_to_idx[d]) for s, d in edges],
            deadline=rng.uniform(*pp.TABLE_I["deadline"])
            * deadline_multiplier,
            payload=rng.uniform(*pp.TABLE_I["input_payload"]),
            rate=rng.uniform(*pp.TABLE_I["arrival_rate"])
            * rate_multiplier * type_mult,
        )
        assert tt.validate_inverse_tree()
        task_types.append(tt)
    return Application(services=services, task_types=task_types)
