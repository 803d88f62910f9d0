"""The port's planning plane, the paper's simulation study: the
discrete-event simulators, Algorithm 1's online controller, the
baselines and the experiment runner (``repro_torch.core`` /
``repro_torch.experiments``), held against the live reference on the
same seeds.

Every random stream a trial draws is derived from its spec, so the
port's copies must return the reference's trial dicts exactly: every
key with tolerance 0 (``metrics_equal``: NaN equals NaN).  Horizons are
short (30 slots, a drain of 100) so the file stays cheap; the scalar
engine, whose proposal loop is the slow one, runs at 20 slots.
"""
import pytest

from repro.core import experiment as j_exp
from repro.experiments import report as j_report
from repro.experiments import results as j_results
from repro.experiments import runner as j_runner
from repro.experiments import scenarios as j_scen
from repro_torch.core import experiment as t_exp
from repro_torch.core import simulator_scalar as t_scalar
from repro_torch.experiments import report as t_report
from repro_torch.experiments import results as t_results
from repro_torch.experiments import runner as t_runner
from repro_torch.experiments import scenarios as t_scen

STRATEGIES = ("proposal", "prop_avg", "lbrr", "ga")
SCENARIOS = ("baseline", "bursty_mmpp", "diurnal", "failure_churn",
             "skewed_mix", "tiered", "scale_load_tiered_25")
SHORT = dict(horizon_slots=30, drain_slots=100)


def _pair(**spec):
    return (j_runner.run_one(j_runner.TrialSpec(**spec)),
            t_runner.run_one(t_runner.TrialSpec(**spec)))


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_run_one_equals_reference(strategy, scenario):
    want, got = _pair(seed=0, strategy=strategy, scenario=scenario, **SHORT)
    assert t_results.metrics_equal(got, want), (got, want)
    assert got["generated"] > 0 and got["completed"] > 0


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_scalar_engine_equals_vectorised(strategy):
    """The fixed-semantics scalar engine consumes the vectorised engine's
    RNG stream and must reproduce its trial dict."""
    spec = t_runner.TrialSpec(seed=1, strategy=strategy, horizon_slots=20,
                              drain_slots=100)
    got = t_scalar.run_one_scalar(spec)
    assert t_results.metrics_equal(got, t_runner.run_one(spec))


def test_run_grid_workers_keep_spec_order():
    specs = t_runner.make_grid(seeds=range(2), strategies=["lbrr", "ga"],
                               horizon_slots=10, drain_slots=60)
    one = t_runner.run_grid(specs, n_workers=1)
    two = t_runner.run_grid(specs, n_workers=2)
    assert len(one) == len(two) == len(specs) == 4
    assert all(t_results.metrics_equal(a, b) for a, b in zip(one, two))
    assert [(r["seed"], r["strategy"]) for r in two] == [
        (s.seed, s.strategy) for s in specs]


def test_grid_summaries_and_report_equal_reference(tmp_path):
    """``make_grid`` / ``run_grid``, ``core.experiment.summarize`` and
    ``run_trial``, ``results.summarize_rows``, the JSON round trip and the
    markdown report, on both packages."""
    kw = dict(seeds=range(3), strategies=list(STRATEGIES),
              scenarios=("baseline",), horizon_slots=8, drain_slots=60)
    want = j_runner.run_grid(j_runner.make_grid(**kw), n_workers=1)
    got = t_runner.run_grid(t_runner.make_grid(**kw), n_workers=1)
    assert len(got) == len(want) == 12
    assert all(t_results.metrics_equal(a, b) for a, b in zip(got, want))
    assert t_exp.summarize(got) == j_exp.summarize(want)
    for keys in (("scenario", "strategy"), ("strategy",), ("seed",),
                 ("strategy", "seed")):
        assert (t_results.summarize_rows(got, keys=keys)
                == j_results.summarize_rows(want, keys=keys))
    trial = t_exp.run_trial(2, ["lbrr", "proposal"], horizon_slots=5,
                            scenario="skewed_mix")
    want_trial = j_exp.run_trial(2, ["lbrr", "proposal"], horizon_slots=5,
                                 scenario="skewed_mix")
    assert all(t_results.metrics_equal(a, b)
               for a, b in zip(trial, want_trial))
    paths = []
    for mod, rows in ((t_results, got), (j_results, want)):
        path = tmp_path / f"{mod.__name__}.json"
        mod.save_results(str(path), rows, meta={"note": "grid"})
        back, meta = mod.load_results(str(path))
        assert meta == {"note": "grid"}
        assert all(mod.metrics_equal(a, b) for a, b in zip(back, rows))
        paths.append(str(path))
    body = lambda text: text.split("\n", 1)[1]  # noqa: E731 (path line)
    assert body(t_report.report(paths[:1])) == body(
        j_report.report(paths[1:]))


def test_registry_and_seeds_equal_reference():
    assert t_scen.list_scenarios() == j_scen.list_scenarios()
    assert set(t_exp.STRATEGIES) == set(j_exp.STRATEGIES) == set(STRATEGIES)
    for name in SCENARIOS + STRATEGIES:
        assert t_exp.stable_seed(name) == j_exp.stable_seed(name)
    assert (t_exp.spawn_rng(3, 7, 1).integers(0, 1 << 30, 8).tolist()
            == j_exp.spawn_rng(3, 7, 1).integers(0, 1 << 30, 8).tolist())
    with pytest.raises(KeyError):
        t_scen.get_scenario("no_such_scenario")
