"""The port's planning plane against the JAX package's, on the CPU.

``repro_torch.core`` (Table I, the application and network generators,
the QoS scores, the static placement integer program and its brute-force
check, the effective-capacity budget and the Lyapunov virtual queues),
the parameter counters of ``repro_torch.config`` and
``repro_torch.microservice.partition`` are copies of the reference's
numpy code.  On the same seeds both packages must give equal arrays,
equal scores and equal placements, exactly (the copies run the same
floating-point operations in the same order).  Nothing here runs a
model.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import effective_capacity as jec  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import lyapunov as jly  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core import paper_params as jpp  # noqa: E402
from repro.core import qos as jqos  # noqa: E402
from repro.core import static_placement as jsp  # noqa: E402
from repro.microservice import partition as jpart  # noqa: E402
from repro.models.quantize import bytes_per_param as jbpp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import effective_capacity as tec  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import lyapunov as tly  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import paper_params as tpp  # noqa: E402
from repro_torch.core import qos as tqos  # noqa: E402
from repro_torch.core import static_placement as tsp  # noqa: E402
from repro_torch.microservice import partition as tpart  # noqa: E402
from repro_torch.models.quantize import bytes_per_param as tbpp  # noqa: E402

SEEDS = [0, 7, 2024]
ARCHS = ["smollm-360m", "falcon-mamba-7b", "gemma3-12b", "zamba2-7b"]
FORMATS = [None, "int8", "int4"]


def _plain(obj):
    """A dataclass / container tree as plain Python for ``==``: arrays
    become (dtype, shape, list) so NaN-free arrays compare exactly."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, np.ndarray):
        return (str(obj.dtype), obj.shape, obj.tolist())
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def test_table_one_is_the_reference():
    names = [n for n in dir(jpp) if n.isupper()]
    assert names == [n for n in dir(tpp) if n.isupper()]
    assert {n: getattr(jpp, n) for n in names} == {
        n: getattr(tpp, n) for n in names}


GENERATORS = {
    "application": lambda m, rng: m.make_application(rng),
    "application-skewed": lambda m, rng: m.make_application(
        rng, rate_multiplier=1.7, type_rate_multipliers=[2, 1, 0.5, 1],
        deadline_multiplier=0.8),
    "network": lambda m, rng: m.make_network(rng),
    "tiered-network": lambda m, rng: m.make_tiered_network(rng),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("what", list(GENERATORS))
def test_generators_equal(what, seed):
    mods = ((jgraph, tgraph) if what.startswith("application")
            else (jnet, tnet))
    want = GENERATORS[what](mods[0], np.random.default_rng(seed))
    got = GENERATORS[what](mods[1], np.random.default_rng(seed))
    assert _plain(got) == _plain(want)


def _instance(graph, net, seed, tiered=False):
    rng = np.random.default_rng(seed)
    app = graph.make_application(rng)
    make = net.make_tiered_network if tiered else net.make_network
    return app, make(rng)


@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
@pytest.mark.parametrize("seed", SEEDS)
def test_qos_scores_and_static_placement_equal(seed, tiered):
    """``qos_scores``, then ``build_problem`` + ``solve`` at two sparsity
    levels and two weight formats: equal scores, problems and placements."""
    japp, jn = _instance(jgraph, jnet, seed, tiered)
    tapp, tn = _instance(tgraph, tnet, seed, tiered)
    jz, jq = jqos.qos_scores(japp, jn)
    tz, tq = tqos.qos_scores(tapp, tn)
    assert _plain((tz, tq)) == _plain((jz, jq))
    for kappa, bpp in ((0, None), (3, 1.0), (6, 0.5)):
        jprob = jsp.build_problem(japp, jn, jz, jq, kappa=kappa,
                                  horizon_slots=100, bytes_per_param=bpp)
        tprob = tsp.build_problem(tapp, tn, tz, tq, kappa=kappa,
                                  horizon_slots=100, bytes_per_param=bpp)
        assert _plain(tprob) == _plain(jprob)
        jx, tx = jsp.solve(jprob), tsp.solve(tprob)
        assert _plain(tx) == _plain(jx)
        assert tprob.objective(tx) == jprob.objective(jx)
        assert tprob.feasible(tx) == jprob.feasible(jx)


def _small_problem(mod, seed):
    rng = np.random.default_rng(seed)
    v, m = 3, 2
    cost = {i: float(rng.uniform(1, 10)) for i in range(m)}
    q = {i: rng.uniform(0, 20, size=v) for i in range(m)}
    z = {i: rng.uniform(0, 1.2, size=v) for i in range(m)}
    box = {i: rng.integers(1, 4, size=v) for i in range(m)}
    return mod.PlacementProblem(cost=cost, q=q, z=z, box=box,
                                kappa=int(rng.integers(0, 4)),
                                xi=float(rng.uniform(0.0, 1.0)))


@pytest.mark.parametrize("seed", [1, 5, 9, 13])
def test_brute_force_equal(seed):
    jprob, tprob = _small_problem(jsp, seed), _small_problem(tsp, seed)
    want, got = jsp.brute_force(jprob, max_inst=3), tsp.brute_force(
        tprob, max_inst=3)
    assert _plain(got) == _plain(want)
    assert _plain(tsp.solve(tprob)) == _plain(jsp.solve(jprob))


@pytest.mark.parametrize("seed", SEEDS)
def test_online_tier_equal(seed):
    """The effective-capacity budget over a grid of Gamma services,
    violation targets and workloads; every light service's ECMap
    (``build_ec_maps``); a run of virtual-queue updates and
    drift-plus-penalty deltas."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        shape, scale = rng.uniform(0.3, 3.0), rng.uniform(0.1, 20.0)
        eps, w = rng.uniform(0.01, 0.5), rng.uniform(0.0, 50.0)
        assert tec.latency_budget(shape, scale, eps, w) == \
            jec.latency_budget(shape, scale, eps, w)
        th = jec.THETA_GRID
        assert np.array_equal(tec.effective_capacity(th, shape, scale),
                              jec.effective_capacity(th, shape, scale))
    japp, _ = _instance(jgraph, jnet, seed)
    tapp, _ = _instance(tgraph, tnet, seed)
    for eps in (0.05, jpp.EPSILON):
        jm, tm = jec.build_ec_maps(japp, eps), tec.build_ec_maps(tapp, eps)
        assert sorted(tm) == sorted(jm)
        for m in jm:
            assert np.array_equal(tm[m].table, jm[m].table)
            assert np.array_equal(tm[m].mean_table, jm[m].mean_table)
            for slack in (1.0, 10.0, 100.0):
                assert (tm[m].max_parallelism(slack)
                        == jm[m].max_parallelism(slack))
    jq, tq = jly.VirtualQueues(), tly.VirtualQueues()
    for step in range(30):
        task = int(rng.integers(0, 4))
        lat, dl = rng.uniform(0, 120), rng.uniform(50, 100)
        if step % 7 == 0:
            jq.admit(task)
            tq.admit(task)
        jq.update(task, lat, dl)
        tq.update(task, lat, dl)
        if step % 11 == 10:
            jq.drop(task)
            tq.drop(task)
        args = (rng.uniform(0, 5), jq.get(task), rng.uniform(-3, 3),
                rng.uniform(0, 10))
        assert tly.drift_plus_penalty_delta(*args) == \
            jly.drift_plus_penalty_delta(*args)
    assert tq.h == jq.h
    assert (tly.ZETA, tly.ETA, tly.PHI_DEFAULT) == (
        jly.ZETA, jly.ETA, jly.PHI_DEFAULT)


@pytest.mark.parametrize("fmt", FORMATS, ids=["bf16", "int8", "int4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decompose_equal(arch, fmt):
    """Stage lists of the full configs at 1-4 core stages (the counters
    ``layer_params`` / ``layer_active_params`` under them)."""
    jc, tc = jget_config(arch), get_config(arch)
    assert tbpp(fmt) == jbpp(fmt)
    for kind in sorted(set(jc.block_pattern)):
        assert tc.layer_params(kind) == jc.layer_params(kind)
        assert tc.layer_active_params(kind) == jc.layer_active_params(kind)
    for n in (1, 2, 3, 4):
        want = jpart.decompose(jc, n_core_stages=n, bytes_per_param=jbpp(fmt))
        got = tpart.decompose(tc, n_core_stages=n, bytes_per_param=tbpp(fmt))
        assert _plain(got) == _plain(want)


def test_unported_kinds_keep_raising():
    """The counters of a cross-attention block and of an encoder-decoder,
    which the port once refused, equal the reference's now that both are
    ported; a block kind neither package knows still raises instead of
    being guessed."""
    tc, jc = get_config("smollm-360m"), jget_config("smollm-360m")
    assert tc.layer_active_params("cross") == jc.layer_active_params("cross")
    assert tc.layer_params("cross") == jc.layer_params("cross")
    over = dict(is_encoder_decoder=True, n_encoder_layers=3, encoder_seq=64)
    assert (dataclasses.replace(tc, **over).num_params()
            == dataclasses.replace(jc, **over).num_params())
    with pytest.raises(ValueError, match="unknown block kind"):
        dataclasses.replace(tc, block_pattern=("attn",) * 31 + ("moe",))


MEASURED = {"none": None,
            "stages": {"stage0": 3.25, "stage1": 1.5, "stage2": 0.75},
            "all": {"tokenize": 0.02, "stage0": 4.0, "stage1": 2.5,
                    "sample": 0.3, "detokenize": 0.01}}


@pytest.mark.parametrize("measured", list(MEASURED))
@pytest.mark.parametrize("arch", ARCHS)
def test_to_application_equal(arch, measured):
    jc, tc = jget_config(arch), get_config(arch)
    n = 3 if measured == "stages" else 2
    jst = jpart.decompose(jc, n_core_stages=n)
    tst = tpart.decompose(tc, n_core_stages=n)
    want = jpart.to_application(jc, jst, np.random.default_rng(11),
                                measured_ms=MEASURED[measured])
    got = tpart.to_application(tc, tst, np.random.default_rng(11),
                               measured_ms=MEASURED[measured])
    assert _plain(got) == _plain(want)


def test_profile_stage_ms_times_a_cpu_call():
    import torch
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2
    ms = tpart.profile_stage_ms(fn, torch.ones(4), iters=3)
    assert ms >= 0.0 and len(calls) == 4  # one warm call, three timed
