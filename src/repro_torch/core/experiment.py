"""Trial primitives: strategy registry, stable seeding, summaries.

Replication-grade seeding: every stream is derived from
`np.random.SeedSequence` entropy lists, and strategy/scenario names are
folded in via `zlib.crc32` — NOT the builtin `hash()`, which is salted
per-process by PYTHONHASHSEED and silently breaks "fixed-seed"
reproducibility across runs.

The parallel grid runner lives in `repro_torch.experiments.runner`;
`run_trial` below is the sequential one-seed convenience wrapper that
routes through the same code path (so its rows are byte-identical to
the runner's for the same spec).

The port's copy of ``repro/core/experiment.py`` (numpy only, line for
line), held against it on equal seeds by tests/test_torch_simulator.py.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.baselines import GAStrategy, LBRRStrategy
from repro_torch.core.online_controller import (PropAvgStrategy,
                                                ProposalStrategy)

STRATEGIES = {
    "proposal": ProposalStrategy,
    "prop_avg": PropAvgStrategy,
    "lbrr": LBRRStrategy,
    "ga": GAStrategy,
}


def stable_seed(name: str) -> int:
    """PYTHONHASHSEED-independent sub-seed for a strategy/scenario name."""
    return zlib.crc32(name.encode("utf-8"))


def spawn_rng(*entropy: int) -> np.random.Generator:
    """Deterministic generator from an entropy tuple (SeedSequence)."""
    return np.random.default_rng(np.random.SeedSequence(list(entropy)))


def build_strategy(name: str, horizon_slots: int = 100, eps: float = 0.2,
                   kappa: Optional[int] = None, seed: int = 0,
                   bytes_per_param: Optional[float] = None):
    """Instantiate a registered strategy with per-kind kwargs.

    `kappa` overrides the proposal's diversity constraint (ablations);
    `seed` feeds the GA's internal generator so replications differ;
    `bytes_per_param` rescales the core services' memory demand for
    quantized placement re-runs (SERVING.md §Quantization).
    """
    cls = STRATEGIES[name]
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


def run_trial(seed: int, strategy_names=None, rate_multiplier: float = 1.0,
              horizon_slots: int = 100, eps: float = 0.2,
              scenario: str = "baseline") -> List[Dict]:
    """Run every requested strategy on one sampled environment."""
    from repro_torch.experiments.runner import TrialSpec, run_one
    out = []
    for name in (strategy_names or STRATEGIES):
        out.append(run_one(TrialSpec(
            seed=seed, strategy=name, scenario=scenario,
            rate_multiplier=rate_multiplier, horizon_slots=horizon_slots,
            eps=eps)))
    return out


def summarize(rows: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Per-strategy aggregate view of trial rows (delegates to the
    general grouped aggregation in repro_torch.experiments.results)."""
    from repro_torch.experiments.results import summarize_rows
    return {s["strategy"]: s
            for s in summarize_rows(rows, keys=("strategy",))}
