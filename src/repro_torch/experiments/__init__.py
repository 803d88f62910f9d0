"""Monte-Carlo experiment harness: scenario registry + parallel runner.

Entry points:

  * `repro_torch.experiments.runner.make_grid` / `run_grid` — build and fan a
    seed x strategy x scenario replication grid across processes;
  * `repro_torch.experiments.scenarios.get_scenario` / `list_scenarios` — the
    named workload/environment dynamics registry;
  * `repro_torch.experiments.results` — versioned machine-readable JSON;
  * `repro_torch.experiments.report` — markdown summary tables from results
    files (``python -m repro_torch.experiments.report FILE --by keys``).

See EXPERIMENTS.md for the CLI and schema documentation.

The port's copy of ``repro/experiments/__init__.py`` (numpy only, line
for line), held against it on equal seeds by
tests/test_torch_simulator.py.
"""
from repro_torch.experiments.results import (load_results,  # noqa: F401
                                             save_results)
from repro_torch.experiments.runner import (TrialSpec, make_grid,  # noqa: F401
                                            run_grid, run_one)
from repro_torch.experiments.scenarios import (get_scenario,  # noqa: F401
                                               list_scenarios)
