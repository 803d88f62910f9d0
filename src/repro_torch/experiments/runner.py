"""Parallel Monte-Carlo replication runner (seed x strategy x scenario).

Fans fully-specified `TrialSpec`s out across worker processes.  Every
random stream a trial consumes is derived from the spec alone via
`np.random.SeedSequence` entropy lists (seed, crc32(scenario),
stream-id[, crc32(strategy)]), so

  * the environment (application + network + churn + modulation) is
    identical for every strategy sharing a (seed, scenario, rate) cell;
  * results are independent of worker count, scheduling order, and
    PYTHONHASHSEED — the same grid replays byte-identical.

Results are plain dicts (Simulator.metrics() plus the spec fields);
`repro_torch.experiments.results` serializes them to the versioned JSON
schema documented in EXPERIMENTS.md.

The port's copy of ``repro/experiments/runner.py`` (numpy only, line for
line), held against it on equal seeds by tests/test_torch_simulator.py.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.core.experiment import (STRATEGIES, build_strategy, spawn_rng,
                                         stable_seed)
from repro_torch.core.simulator import Simulator
from repro_torch.experiments.scenarios import get_scenario

# sub-stream ids inside a (seed, scenario) cell
_ENV_STREAM, _CHURN_STREAM, _MOD_STREAM = 0, 1, 2

WORKERS_ENV = "REPRO_EXP_WORKERS"


@dataclasses.dataclass(frozen=True)
class TrialSpec:
    """One fully-deterministic trial of the replication grid."""
    seed: int
    strategy: str
    scenario: str = "baseline"
    rate_multiplier: float = 1.0
    horizon_slots: int = 100
    drain_slots: int = 400          # post-horizon completion window
    eps: float = 0.2
    kappa: Optional[int] = None     # proposal diversity override
    #: weight bytes/param for core-service memory demand (None = the
    #: bf16 calibration; quantized re-runs pass 1.0 for int8, 0.5 int4)
    bytes_per_param: Optional[float] = None


def make_grid(seeds: Iterable[int],
              strategies: Optional[Sequence[str]] = None,
              scenarios: Sequence[str] = ("baseline",),
              rate_multipliers: Sequence[float] = (1.0,),
              horizon_slots: int = 100, drain_slots: int = 400,
              eps: float = 0.2,
              kappas: Sequence[Optional[int]] = (None,),
              bytes_per_param: Optional[float] = None) -> List[TrialSpec]:
    """Cartesian replication grid in deterministic order."""
    return [TrialSpec(seed=int(seed), strategy=name, scenario=scen,
                      rate_multiplier=float(mult),
                      horizon_slots=horizon_slots,
                      drain_slots=drain_slots, eps=eps, kappa=kappa,
                      bytes_per_param=bytes_per_param)
            for scen in scenarios
            for mult in rate_multipliers
            for seed in seeds
            for name in (strategies or list(STRATEGIES))
            for kappa in kappas]


def run_one(spec: TrialSpec) -> Dict:
    """Build the trial's environment and strategy, run, annotate."""
    scen = get_scenario(spec.scenario)
    sid = stable_seed(spec.scenario)
    env_rng = spawn_rng(spec.seed, sid, _ENV_STREAM)
    app = scen.build_application(env_rng,
                                 rate_multiplier=spec.rate_multiplier)
    net = scen.build_network(env_rng)
    churn = scen.churn_schedule(
        net, spawn_rng(spec.seed, sid, _CHURN_STREAM), spec.horizon_slots)
    modulation = scen.arrival_modulation(
        spawn_rng(spec.seed, sid, _MOD_STREAM))
    strat = build_strategy(spec.strategy, horizon_slots=spec.horizon_slots,
                           eps=spec.eps, kappa=spec.kappa, seed=spec.seed,
                           bytes_per_param=spec.bytes_per_param)
    sim = Simulator(app, net, strat,
                    rng=spawn_rng(spec.seed, sid,
                                  stable_seed(spec.strategy)),
                    horizon_slots=spec.horizon_slots,
                    drain_slots=spec.drain_slots,
                    churn=churn, arrival_modulation=modulation)
    m = sim.run()
    m.update(seed=spec.seed, scenario=spec.scenario,
             rate_multiplier=spec.rate_multiplier,
             horizon_slots=spec.horizon_slots,
             drain_slots=spec.drain_slots, eps=spec.eps,
             kappa=spec.kappa, bytes_per_param=spec.bytes_per_param)
    return m


def default_workers(n_specs: int) -> int:
    env = os.environ.get(WORKERS_ENV)
    n = int(env) if env else (os.cpu_count() or 1)
    return max(1, min(n, n_specs))


def run_grid(specs: Sequence[TrialSpec], n_workers: Optional[int] = None,
             progress: bool = False) -> List[Dict]:
    """Run a grid, fanning out across processes; result order == spec
    order regardless of completion order, so output is deterministic."""
    if not specs:
        return []
    if n_workers is None:
        n_workers = default_workers(len(specs))
    results: List[Dict] = []
    if n_workers <= 1:
        for i, spec in enumerate(specs):
            results.append(run_one(spec))
            if progress:
                print(f"# trial {i + 1}/{len(specs)} done "
                      f"({spec.scenario}/{spec.strategy}/s{spec.seed})",
                      flush=True)
        return results
    # fork is fastest but undefined once torch's threads (or a CUDA
    # context) exist in the parent (e.g. chip_smoke.py or pytest imported
    # torch); forkserver forks from a clean server process instead.
    # Workers only re-import numpy-level modules to unpickle
    # TrialSpec/run_one, so this stays cheap.  The check reads
    # sys.modules and never imports torch itself.
    methods = mp.get_all_start_methods()
    if "fork" in methods and "torch" not in sys.modules:
        method = "fork"
    else:
        method = "forkserver" if "forkserver" in methods else "spawn"
    with ProcessPoolExecutor(max_workers=n_workers,
                             mp_context=mp.get_context(method)) as ex:
        for i, m in enumerate(ex.map(run_one, specs)):
            results.append(m)
            if progress:
                spec = specs[i]
                print(f"# trial {i + 1}/{len(specs)} done "
                      f"({spec.scenario}/{spec.strategy}/s{spec.seed})",
                      flush=True)
    return results
