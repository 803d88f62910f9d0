"""The port's scheduling policies against the JAX package's, on the CPU.

``repro_torch.serving.scheduler`` is a copy of the reference's policy
layer (FIFO, ``edf``, ``edf_ec``, the QoS classes and the SLO
accounting).  Every policy unit case of tests/test_scheduler_policy.py
runs through both packages on the same inputs, with the same hand-
computed expectations (parametrised by package).  The engine-level
cases then drive the port's ``PagedServingEngine`` against the live JAX
engine on bridged weights: the goodput parity sweep of
tests/test_paged.py (FIFO against ``edf`` and ``edf_ec`` on the
overload trace) and the admission-test rejection path, where streams,
``t_*`` stamps, goodput, per-class stats and rejections must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_ref import bridged, config_pair, jax_params  # noqa: E402
from repro.core import effective_capacity as jec  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.core import effective_capacity as tec  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
PKGS = {"jax": (jsched, jengine.Request, jec.latency_budget),
        "torch": (tsched, tengine.Request, tec.latency_budget)}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def _req(pkg, i, qos="standard", t_submit=0, **kw):
    r = pkg[1](id=i, prompt=kw.pop("prompt", [1, 2, 3]), qos=qos, **kw)
    r.t_submit = t_submit
    return r


def _view(pkg, free_blocks, granule=8, total=16):
    return pkg[0].CapacityView(free_tokens=free_blocks * granule,
                               total_tokens=total * granule,
                               granule=granule)


def test_qos_classes_equal():
    assert tsched.QOS_CLASSES == {
        k: tsched.QoSClass(**vars(v)) for k, v in jsched.QOS_CLASSES.items()}
    assert (tsched.ADMIT, tsched.DEFER, tsched.REJECT) == (
        jsched.ADMIT, jsched.DEFER, jsched.REJECT)
    for cls in ("EDFCapacityPolicy",):
        for k in ("EWMA_ALPHA", "MIN_SAMPLES", "SAMPLE_WINDOW"):
            assert getattr(getattr(tsched, cls), k) == getattr(
                getattr(jsched, cls), k)


def test_make_policy_registry(pkg):
    s = pkg[0]
    assert isinstance(s.make_policy(None), s.FIFOPolicy)
    assert s.make_policy("edf").name == "edf"
    assert s.make_policy("edf_ec").name == "edf_ec"
    p = s.EDFPolicy()
    assert s.make_policy(p) is p
    with pytest.raises(ValueError):
        s.make_policy("lottery")


def test_fifo_is_the_historical_discipline(pkg):
    pol = pkg[0].SchedulerPolicy()
    q = [_req(pkg, 0, t_submit=5), _req(pkg, 1, t_submit=0)]
    assert pol.next_admission(q, 10) is q[0]
    cands = [(3, q[0]), (1, q[1])]
    assert pol.select_victim(cands, 10, needy=3) == 1
    assert pol.admission_test(q[0], 10, None) == (pkg[0].ADMIT, None)
    assert pol.max_preemptions is None


def test_edf_ordering(pkg):
    """Class deadlines, the resume deadline (the next token's), the
    deterministic tiebreak."""
    pol = pkg[0].EDFPolicy()
    q = [_req(pkg, 0, "batch"), _req(pkg, 1, "standard"),
         _req(pkg, 2, "interactive")]
    assert pol.next_admission(q, 0).id == 2
    q.pop(2)
    assert pol.next_admission(q, 0).id == 1
    resume = _req(pkg, 0, "standard", t_submit=0, out_tokens=[9, 9, 9])
    resume.t_admit, resume.t_first = 1, 2
    fresh = _req(pkg, 1, "interactive", t_submit=10)
    assert pol.deadline(resume) == 18
    assert pol.deadline(fresh) == 26
    assert pol.next_admission([fresh, resume], 12).id == 0
    q = [_req(pkg, 7, "standard"), _req(pkg, 3, "standard")]
    assert pol.next_admission(q, 0).id == 3


def test_ec_admission_boundaries(pkg):
    """Admit when it fits now; reject on exhausted TTFT slack; the
    reject/defer boundary where eq. 21's inversion puts it; resumed
    requests always pass."""
    s, _, latency_budget = pkg
    pol = s.EDFCapacityPolicy(service_shape=2.0, service_scale=0.5)
    req = _req(pkg, 0, "interactive", prompt=[1] * 20)
    assert pol.admission_test(req, 0, _view(pkg, 3))[0] == s.ADMIT
    req = _req(pkg, 0, "interactive", t_submit=0)
    verdict, msg = pol.admission_test(req, 17, _view(pkg, 0))
    assert verdict == s.REJECT and "interactive" in msg
    cls = s.get_qos("standard")
    deficit, view = 4, _view(pkg, 0)
    d = latency_budget(2.0, 0.5, cls.eps, float(deficit))
    tight = _req(pkg, 0, "standard", t_submit=0,
                 prompt=[1] * (deficit * view.granule), max_new_tokens=0)
    assert pol.admission_test(tight, int(cls.ttft - d) + 1,
                              view)[0] == s.REJECT
    assert pol.admission_test(tight, int(cls.ttft - d) - 1,
                              view)[0] == s.DEFER
    req = _req(pkg, 0, "interactive", t_submit=0, out_tokens=[4])
    req.t_admit = 1
    assert pol.admission_test(req, 999, _view(pkg, 0))[0] == s.ADMIT


def test_ec_defers_until_service_model_warm(pkg):
    s = pkg[0]
    pol = s.EDFCapacityPolicy()
    req = _req(pkg, 0, "standard", t_submit=0, prompt=[1] * 64)
    assert pol.admission_test(req, 1, _view(pkg, 1))[0] == s.DEFER
    horizon = pol.SAMPLE_WINDOW * (pol.MIN_SAMPLES + 8) + 2
    for t in range(1, horizon):
        pol.on_step(t, [], [])
        pol.on_free(1, t)
    shape, scale = pol.service_stats()
    assert shape is not None and shape * scale == pytest.approx(1.0, rel=0.2)
    assert pol.admission_test(req, 1, _view(pkg, 1))[0] in (s.DEFER,
                                                            s.REJECT)


def test_ec_service_estimate_equal():
    """An irregular freeing trace through both packages' estimators:
    equal (shape, scale) at every step and equal verdicts, with the
    speculative speedup applied to fixed priors."""
    rng = np.random.default_rng(3)
    pols = [s.EDFCapacityPolicy() for s in (jsched, tsched)]
    for t in range(1, 200):
        freed = int(rng.poisson(0.8)) * int(rng.integers(0, 4))
        for p in pols:
            p.on_step(t, [], [])
            p.on_free(freed, t)
        assert pols[0].service_stats() == pols[1].service_stats()
    for spec in (1.0, 2.5):
        for fixed in (False, True):
            out = []
            for name, (s, req_cls, _) in PKGS.items():
                pol = (s.EDFCapacityPolicy(service_shape=1.5,
                                           service_scale=0.4)
                       if fixed else pols[name == "torch"])
                req = req_cls(id=0, prompt=[1] * 50, qos="standard")
                req.t_submit = 0
                view = s.CapacityView(free_tokens=8, total_tokens=128,
                                      granule=8, spec_accept=spec)
                out.append([pol.admission_test(req, t, view)
                            for t in range(0, 50, 3)])
            assert out[0] == out[1]


def test_victim_selection(pkg):
    """Most slack, never a protected request; no protection for an
    already-missed TTFT; ties to the newest admission."""
    s = pkg[0]
    pol = s.EDFPolicy(ttft_protect=4)
    t = 14
    prot = _req(pkg, 0, "interactive", t_submit=2)
    std = _req(pkg, 1, "standard", t_submit=0, out_tokens=[5, 5])
    std.t_admit, std.t_first = 2, 4
    bat = _req(pkg, 2, "batch", t_submit=0, out_tokens=[5])
    bat.t_admit, bat.t_first = 2, 4
    assert pol.select_victim([(0, prot), (1, std), (2, bat)], t,
                             needy=0) == 2
    assert pol.select_victim([(0, prot), (1, std)], t, needy=1) == 1
    assert pol.select_victim([(0, prot)], t, needy=0) is None
    missed = _req(pkg, 0, "interactive", t_submit=0)
    assert pol.select_victim([(0, missed)], 30, needy=0) == 0
    pol = s.EDFPolicy()
    a, b = _req(pkg, 0, "batch"), _req(pkg, 1, "batch")
    for r in (a, b):
        r.t_admit, r.t_first = 1, 2
        r.out_tokens = [7]
    assert pol.select_victim([(0, a), (1, b)], 5, needy=0) == 1


def test_slack_aging_promotes_starving_batch(pkg):
    pol = pkg[0].EDFPolicy(age_rate=0.5)
    starving = _req(pkg, 0, "batch", t_submit=0)
    promoted_at = None
    for t in range(1, 513):
        q = [_req(pkg, 100 + t, "interactive", t_submit=t), starving]
        pol.on_step(t, q, [])
        if pol.next_admission(q, t).id == 0:
            promoted_at = t
            break
    assert promoted_at is not None and 100 < promoted_at <= 340


def test_virtual_queue_drift(pkg):
    """Eq. (18)'s hand trace, the longest wait per class, and the boost
    the debt gives the admission key."""
    pol = pkg[0].EDFPolicy()
    r = _req(pkg, 0, "interactive", t_submit=0)
    assert pol.vq.get("interactive") == 1.0
    pol.on_step(20, [r], [])
    assert pol.vq.get("interactive") == 5.0
    pol.on_step(21, [r], [])
    assert pol.vq.get("interactive") == 10.0
    pol.on_step(22, [], [])
    assert pol.vq.get("interactive") == 1.0
    r.t_admit = 22
    pol.on_step(40, [r], [])
    assert pol.vq.get("interactive") == 1.0
    pol = pkg[0].EDFPolicy()
    old = _req(pkg, 0, "interactive", t_submit=0)
    young = _req(pkg, 1, "interactive", t_submit=15)
    pol.on_step(20, [young, old], [])
    assert pol.vq.get("interactive") == 5.0
    pol = pkg[0].EDFPolicy(age_rate=0.0)
    std = _req(pkg, 0, "standard", t_submit=0)
    itv = _req(pkg, 1, "interactive", t_submit=40)
    assert pol.next_admission([std, itv], 40).id == 0
    pol.vq.update("interactive", 20.0, 16.0)
    assert pol.next_admission([std, itv], 40).id == 1


def test_slo_accounting(pkg):
    s = pkg[0]
    r = _req(pkg, 0, "interactive", t_submit=0, out_tokens=[1] * 4,
             max_new_tokens=4)
    r.t_admit, r.t_first = 1, 16
    r.t_done = 22
    assert s.slo_met(r) and s.ttft_met(r) and s.tpot_met(r)
    r.t_done = 23
    assert not s.slo_met(r) and not s.tpot_met(r)
    r.t_first = 17
    r.t_done = r.t_first + 6
    assert not s.slo_met(r) and not s.ttft_met(r)
    ok = _req(pkg, 0, "batch", t_submit=0, out_tokens=[1], max_new_tokens=1)
    ok.t_admit = ok.t_first = ok.t_done = 1
    rej = _req(pkg, 1, "batch", t_submit=0)
    rej.error, rej.t_done = "rejected", 1
    hung = _req(pkg, 2, "batch", t_submit=0)
    assert s.goodput([ok, rej, hung]) == pytest.approx(1 / 3)
    stats = s.per_class_stats([ok, rej, hung])
    assert (stats["batch"]["n"], stats["batch"]["rejected"]) == (3, 1)
    assert stats["batch"]["goodput"] == pytest.approx(1 / 3)
    assert s.goodput([]) == 0.0


# ----------------------------------------------------------------------
# engine level: the port's paged engine against the live JAX engine
# ----------------------------------------------------------------------
#: tests/test_paged.py's GOODPUT_TRACE: two batch hogs ahead of four
#: interactive requests
GOODPUT_TRACE = [
    ("batch", [5, 6, 7], 20),
    ("batch", [9, 10, 4], 20),
    ("interactive", [11, 3, 5], 4),
    ("interactive", [2, 8], 4),
    ("interactive", [7, 7, 1], 4),
    ("interactive", [4, 9, 9, 2], 4),
]


@pytest.fixture(scope="module", params=["mha", "mamba"])
def model(request):
    jc, tc = config_pair(request.param)
    npp = jax_params(jc, seed=5)
    return jc, tc, npp, bridged(npp, tc)


def _goodput_run(engine_cls, req_cls, sched, cfg, params, policy, k,
                 **kw):
    eng = engine_cls(cfg, params, max_rows=2, max_len=32, block_size=8,
                     prefill_chunk=4, decode_steps=k, policy=policy, **kw)
    reqs = [req_cls(id=i, prompt=list(p), max_new_tokens=n, qos=q)
            for i, (q, p, n) in enumerate(GOODPUT_TRACE)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    eng.pc.check()
    return {"streams": {r.id: list(r.out_tokens) for r in reqs},
            "stamps": [(r.t_submit, r.t_admit, r.t_first, r.t_done)
                       for r in reqs],
            "goodput": sched.goodput(reqs),
            "per_class": sched.per_class_stats(reqs),
            "rejected": [(r.id, r.t_done, r.error) for r in eng.rejected],
            "unfinished": [r.id for r in eng.unfinished],
            "n_preemptions": eng.n_preemptions}


@pytest.mark.parametrize("k", [1, 8])
def test_goodput_parity_sweep(model, k):
    """FIFO, ``edf`` and ``edf_ec`` on the overload trace: the port
    equals the JAX engine under each policy (streams, stamps, goodput,
    per-class stats, rejections); each policy's streams equal FIFO's, and
    EDF admits the interactive tier first and meets every deadline."""
    jc, tc, npp, tp = model
    runs = {}
    for policy in ("fifo", "edf", "edf_ec"):
        want = _goodput_run(jengine.PagedServingEngine, jengine.Request,
                            jsched, jc, npp, policy, k)
        got = _goodput_run(tengine.PagedServingEngine, tengine.Request,
                           tsched, tc, tp, policy, k, device="cpu")
        assert got == want, policy
        runs[policy] = got
    for policy in ("edf", "edf_ec"):
        assert runs[policy]["streams"] == runs["fifo"]["streams"]
    assert not runs["edf"]["rejected"] and not runs["edf"]["unfinished"]
    assert runs["fifo"]["goodput"] < 1.0
    assert runs["edf"]["goodput"] == 1.0
    stamps = runs["edf"]["stamps"]
    assert max(s[1] for s, (q, _, _) in zip(stamps, GOODPUT_TRACE)
               if q == "interactive") < min(
        s[1] for s, (q, _, _) in zip(stamps, GOODPUT_TRACE) if q == "batch")


def test_admission_test_rejects_like_the_reference(model):
    """A slow fixed service prior: a long interactive prompt behind a
    batch hog is rejected before first admission on both sides, with
    the same stamps, error and surviving stream."""
    jc, tc, npp, tp = model
    out = []
    for eng_cls, req_cls, sched, cfg, params, kw in (
            (jengine.PagedServingEngine, jengine.Request, jsched, jc, npp,
             {}),
            (tengine.PagedServingEngine, tengine.Request, tsched, tc, tp,
             {"device": "cpu"})):
        pol = sched.EDFCapacityPolicy(service_shape=1.0, service_scale=0.25)
        eng = eng_cls(cfg, params, max_rows=2, max_len=64, block_size=8,
                      num_blocks=8, prefill_chunk=8, decode_steps=4,
                      policy=pol, **kw)
        eng.submit(req_cls(id=0, prompt=[2] * 32, max_new_tokens=20,
                           qos="batch"))
        eng.run(max_steps=2)
        eng.submit(req_cls(id=1, prompt=[3] * 60, max_new_tokens=4,
                           qos="interactive"))
        done = eng.run()
        out.append({"done": [(r.id, r.out_tokens, r.t_admit, r.t_done)
                             for r in done],
                    "rejected": [(r.id, r.t_submit, r.t_admit, r.t_done,
                                  r.error) for r in eng.rejected]})
    assert out[1] == out[0]
    assert [r[0] for r in out[1]["rejected"]] == [1]
    assert "effective-capacity" in out[1]["rejected"][0][4]
