"""Render replication-runner results JSON as markdown summary tables.

Thin CLI over :func:`repro_torch.experiments.results.summarize_rows` /
:func:`markdown_table`: load one or more versioned results files, group
rows by the requested spec columns, and print a GitHub-flavored table
(plus the file meta for provenance).  This is the reporting entry point
the scale_load sweep (benchmarks/scale_load.py) and ad-hoc grid runs
share::

    PYTHONPATH=src python -m repro_torch.experiments.report \
        bench_scale_load.json --by scenario,strategy

Any spec field stored on the rows works as a group key (scenario,
strategy, rate_multiplier, seed, kappa, horizon_slots, ...).

The port's copy of ``repro/experiments/report.py`` (numpy only, line for
line), held against it on equal seeds by tests/test_torch_simulator.py.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Sequence

from repro_torch.experiments.results import (load_results, markdown_table,
                                             summarize_rows)


def report(paths: Sequence[str],
           by: Sequence[str] = ("scenario", "strategy")) -> str:
    """Markdown report for the concatenated rows of `paths`."""
    out: List[str] = []
    rows: List[Dict] = []
    for path in paths:
        file_rows, meta = load_results(path)
        rows.extend(file_rows)
        desc = ", ".join(f"{k}={v}" for k, v in sorted(meta.items())
                         if not isinstance(v, (dict, list)))
        out.append(f"**{path}** ({len(file_rows)} rows; {desc})")
    out.append("")
    out.append(markdown_table(summarize_rows(rows, keys=tuple(by)),
                              keys=tuple(by)))
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="summarize replication-runner results JSON")
    ap.add_argument("results", nargs="+", help="results JSON file(s)")
    ap.add_argument("--by", default="scenario,strategy",
                    help="comma-separated group-by spec columns")
    args = ap.parse_args(argv)
    print(report(args.results, by=tuple(args.by.split(","))))


if __name__ == "__main__":
    main()
