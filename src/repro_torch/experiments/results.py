"""Versioned, machine-readable JSON results for the replication runner.

File layout (EXPERIMENTS.md §JSON schema)::

    {
      "schema_version": 1,
      "meta":  {...free-form provenance: grid, section, cli args...},
      "rows":  [ {<Simulator.metrics() + spec fields>}, ... ]
    }

Serialization is deterministic: keys are sorted, separators fixed, and
NaNs (e.g. latency percentiles of an empty trial) are written as null
so the files are strict JSON and byte-identical across replays.

The port's copy of ``repro/experiments/results.py`` (numpy only, line
for line), held against it on equal seeds by
tests/test_torch_simulator.py.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

SCHEMA_VERSION = 1


def _clean(obj):
    """NaN/inf -> None; numpy scalars -> python (strict JSON)."""
    if isinstance(obj, dict):
        return {k: _clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_clean(v) for v in obj]
    if isinstance(obj, (np.floating, float)):
        f = float(obj)
        return f if math.isfinite(f) else None
    if isinstance(obj, (np.integer,)):
        return int(obj)
    return obj


def dumps(rows: Sequence[Dict], meta: Optional[Dict] = None) -> str:
    doc = {"schema_version": SCHEMA_VERSION, "meta": _clean(meta or {}),
           "rows": _clean(list(rows))}
    return json.dumps(doc, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def save_results(path: str, rows: Sequence[Dict],
                 meta: Optional[Dict] = None) -> None:
    with open(path, "w") as f:
        f.write(dumps(rows, meta))
        f.write("\n")


def load_results(path: str) -> Tuple[List[Dict], Dict]:
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):       # pre-schema flat row dumps
        return doc, {}
    assert doc.get("schema_version") == SCHEMA_VERSION, doc.get(
        "schema_version")
    return doc["rows"], doc.get("meta", {})


# ----------------------------------------------------------------------
# Aggregation
# ----------------------------------------------------------------------
def metrics_equal(a: Dict, b: Dict) -> bool:
    """Exact equality for trial-metric dicts, with NaN == NaN.

    Empty trials (nothing completed) have NaN latency percentiles in
    BOTH engines; plain dict `==` would flag those identical rows as
    divergent (nan != nan), so equality gates (chip_smoke.py's planning
    phase, tests/test_torch_simulator.py) use this instead."""
    if a.keys() != b.keys():
        return False
    for k, va in a.items():
        vb = b[k]
        if (isinstance(va, float) and isinstance(vb, float)
                and math.isnan(va) and math.isnan(vb)):
            continue
        if va != vb:
            return False
    return True


def summarize_rows(rows: Iterable[Dict],
                   keys: Sequence[str] = ("scenario", "strategy",
                                          "rate_multiplier")
                   ) -> List[Dict]:
    """Group rows by `keys`, aggregate the headline metrics."""
    groups: Dict[tuple, List[Dict]] = {}
    for r in rows:
        groups.setdefault(tuple(r.get(k) for k in keys), []).append(r)

    def _ordering(t):
        # type-aware: numeric columns sort numerically (kappa 0 < 6 < 12,
        # not lexicographic "0" < "12" < "6"), None last
        return tuple((v is None, not isinstance(v, (int, float)),
                      v if isinstance(v, (int, float)) else str(v))
                     for v in t)

    out = []
    for gkey in sorted(groups, key=_ordering):
        rs = groups[gkey]

        def col(c):
            return np.array([r[c] for r in rs], dtype=float)

        ot, comp, cost = col("on_time"), col("completed"), col("total_cost")
        summ = dict(zip(keys, gkey))
        summ.update({
            "n_trials": len(rs),
            "on_time_mean": float(ot.mean()),
            "on_time_p10": float(np.percentile(ot, 10)),
            "on_time_p50": float(np.percentile(ot, 50)),
            "on_time_p90": float(np.percentile(ot, 90)),
            "on_time_std": float(ot.std()),
            "completed_mean": float(comp.mean()),
            "completed_std": float(comp.std()),
            "gap_mean": float((comp - ot).mean()),
            "cost_mean": float(cost.mean()),
            "cost_std": float(cost.std()),
        })
        out.append(summ)
    return out


def markdown_table(summaries: Sequence[Dict],
                   keys: Sequence[str] = ("scenario", "strategy",
                                          "rate_multiplier")) -> str:
    """Render grouped summaries as a GitHub-flavored markdown table."""
    cols = list(keys) + ["n_trials", "on_time_mean", "on_time_p10",
                         "on_time_p90", "completed_mean", "cost_mean"]
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "---|" * len(cols)]
    for s in summaries:
        cells = []
        for c in cols:
            v = s.get(c)
            cells.append(f"{v:.4f}" if isinstance(v, float) else str(v))
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)
