"""Scenario registry: named workload + environment dynamics.

A Scenario bundles everything a Monte-Carlo trial samples besides the
strategy: the application instance, the network topology, a per-slot
arrival-rate modulation (workload dynamics), and a node
failure/recovery churn schedule (environment dynamics).  Each is a
named config runnable from ``python -m benchmarks.run --scenario
<name>`` and addressable from the grid runner.

Registered scenarios:

  baseline       paper Table-I instance, stationary Poisson arrivals
  bursty_mmpp    2-state Markov-modulated Poisson arrival process
  diurnal        sinusoidal (day/night) load with random phase
  failure_churn  rolling edge-server outages with recovery
  skewed_mix     one task type dominates the arrival mix
  tiered         heterogeneous cloud / edge / device network
  scale_load_N          N-user population on a proportionally scaled
                        two-tier metro (N in SCALE_LOAD_USERS, 10..500)
  scale_load_tiered_N   same sweep over the four-tier cloud/edge/device
                        topology (the `tiered` pairing)

Scenarios are instantiated per trial (they may hold rng state for the
modulation process); everything they sample is driven by generators the
runner spawns from the trial's SeedSequence, so trials replay exactly.

The port's copy of ``repro/experiments/scenarios.py`` (numpy only, line
for line), held against it on equal seeds by
tests/test_torch_simulator.py.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type

import numpy as np

from repro_torch.core import paper_params as pp_defaults
from repro_torch.core.graph import Application, make_application
from repro_torch.core.network import (EdgeNetwork, make_network,
                                      make_tiered_network)
from repro_torch.core.simulator import ChurnEvent

_REGISTRY: Dict[str, Type["Scenario"]] = {}


def register(cls: Type["Scenario"]) -> Type["Scenario"]:
    assert cls.name and cls.name not in _REGISTRY, cls.name
    _REGISTRY[cls.name] = cls
    return cls


def get_scenario(name: str) -> "Scenario":
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def list_scenarios() -> Dict[str, str]:
    return {n: cls.description for n, cls in sorted(_REGISTRY.items())}


# ----------------------------------------------------------------------
# Arrival-rate modulation processes (called once per generation slot)
# ----------------------------------------------------------------------
class MMPPModulation:
    """2-state Markov-modulated Poisson process: arrival rates switch
    between a quiet multiplier and a burst multiplier with per-slot
    transition probabilities.  Mean multiplier ~1 for the defaults, so
    aggregate load matches baseline but arrives in bursts."""

    def __init__(self, rng: np.random.Generator, low: float = 0.4,
                 high: float = 2.8, p_low_high: float = 0.08,
                 p_high_low: float = 0.24):
        self.rng = rng
        self.mults = (low, high)
        self.p_switch = (p_low_high, p_high_low)
        self.state = 0

    def __call__(self, t_slot: int) -> float:
        if self.rng.random() < self.p_switch[self.state]:
            self.state = 1 - self.state
        return self.mults[self.state]


class DiurnalModulation:
    """Sinusoidal load: 1 + amp * sin(2*pi*(t/period + phase))."""

    def __init__(self, rng: np.random.Generator, amp: float = 0.6,
                 period_slots: float = 48.0):
        self.amp = amp
        self.period = period_slots
        self.phase = float(rng.uniform(0.0, 1.0))

    def __call__(self, t_slot: int) -> float:
        return max(0.0, 1.0 + self.amp * np.sin(
            2.0 * np.pi * (t_slot / self.period + self.phase)))


# ----------------------------------------------------------------------
# Scenarios
# ----------------------------------------------------------------------
class Scenario:
    """Base: the paper's stationary Table-I evaluation setup."""

    name = ""
    description = ""

    def build_application(self, rng: np.random.Generator,
                          rate_multiplier: float = 1.0) -> Application:
        return make_application(rng, rate_multiplier=rate_multiplier)

    def build_network(self, rng: np.random.Generator) -> EdgeNetwork:
        return make_network(rng)

    def arrival_modulation(
            self, rng: np.random.Generator
    ) -> Optional[Callable[[int], float]]:
        return None

    def churn_schedule(self, net: EdgeNetwork, rng: np.random.Generator,
                       horizon_slots: int) -> List[ChurnEvent]:
        return []


@register
class BaselineScenario(Scenario):
    name = "baseline"
    description = ("paper Table-I instance: stationary Poisson arrivals, "
                   "static ED/ES topology, no faults")


@register
class BurstyMMPPScenario(Scenario):
    name = "bursty_mmpp"
    description = ("2-state MMPP arrivals: quiet 0.4x / burst 2.8x rate "
                   "switching, ~baseline mean load")

    def arrival_modulation(self, rng):
        return MMPPModulation(rng)


@register
class DiurnalScenario(Scenario):
    name = "diurnal"
    description = ("sinusoidal day/night load, amplitude 0.6, period 48 "
                   "slots, random phase per trial")

    def arrival_modulation(self, rng):
        return DiurnalModulation(rng)


@register
class FailureChurnScenario(Scenario):
    name = "failure_churn"
    description = ("rolling edge-server outages: every ES fails for a "
                   "window inside the horizon, staggered, then recovers")

    # fraction of the horizon each ES stays down
    down_frac = 0.25

    def churn_schedule(self, net, rng, horizon_slots):
        """Stagger one outage window per ES across the horizon.  Any
        placement concentrated on a single server is guaranteed to be
        hit by some window; a kappa-diverse backbone keeps serving."""
        ess = [int(v) for v in np.flatnonzero(net.is_es)]
        rng.shuffle(ess)
        down = max(2, int(self.down_frac * horizon_slots))
        events: List[ChurnEvent] = []
        for i, v in enumerate(ess):
            start = max(1, int((i + 0.5) * horizon_slots / (len(ess) + 1)))
            events.append(ChurnEvent(slot=start, node=v, action="fail"))
            events.append(ChurnEvent(slot=start + down, node=v,
                                     action="recover"))
        return events


@register
class SkewedMixScenario(Scenario):
    name = "skewed_mix"
    description = ("one task type dominates the arrival mix (3x rate), "
                   "the rest are throttled to 0.5x; dominant type "
                   "rotates with the trial seed")

    def build_application(self, rng, rate_multiplier=1.0):
        from repro_torch.core import paper_params as pp
        mults = [0.5] * pp.N_TASK_TYPES
        mults[int(rng.integers(pp.N_TASK_TYPES))] = 3.0
        return make_application(rng, rate_multiplier=rate_multiplier,
                                type_rate_multipliers=mults)


@register
class TieredScenario(Scenario):
    name = "tiered"
    description = ("four-tier cloud/edge/device network: weak near-user "
                   "devices, metro EDs/ESs, one far high-capacity cloud")

    def build_network(self, rng):
        return make_tiered_network(rng)


# ----------------------------------------------------------------------
# scale_load family: population scaling (the vectorized engine's raison
# d'etre — the scalar loop ground to a halt past a few dozen users)
# ----------------------------------------------------------------------
SCALE_LOAD_USERS = (10, 25, 50, 100, 200, 500)


class ScaleLoadScenario(Scenario):
    """``scale_load_N``: N users on a two-tier metro whose node counts
    grow with the population (~4 users per ED / per ES vs. the
    baseline's 1.5), so both aggregate load and per-node contention
    rise with N.  Everything else is the paper's Table-I instance."""

    n_users = 10

    def _topo(self):
        n_eds = max(pp_defaults.N_EDS, -(-self.n_users // 4))
        n_ess = max(pp_defaults.N_ESS, -(-self.n_users // 4))
        return n_eds, n_ess

    def build_network(self, rng):
        n_eds, n_ess = self._topo()
        return make_network(rng, n_eds=n_eds, n_ess=n_ess,
                            n_users=self.n_users)


class ScaleLoadTieredScenario(ScaleLoadScenario):
    """``scale_load_tiered_N``: the same population sweep entering the
    four-tier cloud/edge/device topology (devices scale with users; one
    far cloud absorbs the overflow)."""

    def build_network(self, rng):
        n_eds, n_ess = self._topo()
        return make_tiered_network(rng,
                                   n_devices=max(4, -(-self.n_users // 8)),
                                   n_eds=n_eds, n_ess=n_ess,
                                   n_users=self.n_users)


for _n in SCALE_LOAD_USERS:
    register(type(f"ScaleLoad{_n}", (ScaleLoadScenario,), {
        "name": f"scale_load_{_n}", "n_users": _n,
        "description": (f"{_n} users on a proportionally scaled two-tier "
                        f"metro (scale_load family)")}))
    register(type(f"ScaleLoadTiered{_n}", (ScaleLoadTieredScenario,), {
        "name": f"scale_load_tiered_{_n}", "n_users": _n,
        "description": (f"{_n} users on a proportionally scaled four-tier "
                        f"cloud/edge/device network (scale_load family)")}))
