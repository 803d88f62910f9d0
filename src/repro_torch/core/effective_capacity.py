"""Effective capacity theory (Sec. III-B, eqs 20-21).

For a light MS whose per-slot service rate is i.i.d. Gamma(shape a, scale
s) MB/ms, the log-MGF is closed-form, giving

    E_c(theta) = a * ln(1 + theta * s) / theta          (nats/MB scale)

At parallelism y the per-task rate is f/y, i.e. scale s/y.  The QoS
exponent theta links E_c to the latency-tail (eq. 21):

    P{d > D} ~ (E_c(theta)/E[f]) * exp(-theta * E_c(theta) * D)

so the smallest statistically-safe latency budget for violation
probability eps at parallelism y is

    g_{m,eps}(y) = workload_scaled * min_theta D(theta)
    D(theta) = ln(E_c(theta) / (eps * E[f/y])) / (theta * E_c(theta))

We precompute the min over a log-spaced theta grid (vectorized in numpy)
— this is the paper's "pre-calculated deterministic mapping".

The port's copy of ``repro/core/effective_capacity.py`` (numpy only, line for line),
held against it on equal seeds by tests/test_torch_planning.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

THETA_GRID = np.logspace(-3.0, 2.5, 160)


def effective_capacity(theta, shape, scale):
    """E_c(theta) for Gamma(shape, scale) service increments (MB/ms)."""
    return shape * np.log1p(theta * scale) / theta


def latency_budget(shape: float, scale: float, eps: float,
                   workload: float) -> float:
    """Chernoff/large-deviations inversion of eq. (21).

    Time d such that P{F(0,d) < workload} <= eps, where F is the
    cumulative Gamma(shape, scale) service process:

      P{F(0,t) < w} <= exp(theta*w - t*theta*E_c(theta))   (theta > 0)
      => d(theta) = (w + ln(1/eps)/theta) / E_c(theta)
      => g = min_theta d(theta).

    As w grows, g -> w / E_c(theta*): the effective-capacity service rate,
    strictly below the mean rate — the tail-aware margin the PropAvg
    ablation lacks.
    """
    th = THETA_GRID
    ec = effective_capacity(th, shape, scale)
    d = (workload + np.log(1.0 / eps) / th) / ec
    return float(np.min(d))


@dataclass
class ECMap:
    """Deterministic map g_{m,eps}(y) for one light MS."""

    a_mb: float          # workload per task
    shape: float
    scale: float
    eps: float
    y_max: int = 64

    def __post_init__(self):
        # y-way contention: the instance must serve y*a_mb of work for a
        # task admitted at parallelism y
        self.table = np.array([
            latency_budget(self.shape, self.scale, self.eps, self.a_mb * y)
            for y in range(1, self.y_max + 1)])
        mean_rate = self.shape * self.scale
        self.mean_table = np.array([
            self.a_mb * y / mean_rate for y in range(1, self.y_max + 1)])

    def g(self, y: int) -> float:
        """QoS-aware processing-delay estimate at parallelism y (ms)."""
        y = int(np.clip(y, 1, self.y_max))
        return float(self.table[y - 1])

    def g_mean(self, y: int) -> float:
        """PropAvg ablation: mean-value estimate (no tail awareness)."""
        y = int(np.clip(y, 1, self.y_max))
        return float(self.mean_table[y - 1])

    def max_parallelism(self, slack_ms: float) -> int:
        """Largest y whose safe latency still fits in `slack_ms`."""
        ok = np.nonzero(self.table <= slack_ms)[0]
        return int(ok[-1] + 1) if len(ok) else 0


def build_ec_maps(app, eps: float) -> dict:
    """ECMap per light MS of an Application."""
    return {m: ECMap(app.ms(m).a, app.ms(m).f_shape, app.ms(m).f_scale, eps)
            for m in app.light_ids}
