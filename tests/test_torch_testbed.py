"""The port's scheduler testbed and dispatch counter against the
reference's, on the CPU.

* ``FakeEngine`` (the real paged scheduler over an integer recurrence):
  streams, ``t_*`` stamps, preemptions, prefix hits, COW copies and the
  policy's rejections equal to the reference's under ``fifo``, ``edf``
  and ``edf_ec`` on an overloaded pool, and every stream equal to
  ``fake_stream``'s oracle.
* ``ScriptedDraft``: the same proposals, and under chosen acceptance
  schedules the same verify accounting (``spec_*`` counters, streams,
  stamps) as the reference's testbed.
* ``instrument``: on the same traces, the port's engines count their
  device calls under the reference's program names with the reference's
  counts (paged with preemption and prefix hits, slot, a model draft,
  a 2-stage pipeline with its profile, a speculative pipeline), on
  bridged weights with equal streams.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_ref import bridged, config_pair, jax_params  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import instrument as jinst  # noqa: E402
from repro.serving import pipeline as jpipe  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
from repro.serving import testbed as jbed  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import instrument as tinst  # noqa: E402
from repro_torch.serving import pipeline as tpipe  # noqa: E402
from repro_torch.serving import speculative as tspec  # noqa: E402
from repro_torch.serving import testbed as tbed  # noqa: E402

PKGS = {"jax": (jbed, jengine.Request), "torch": (tbed, tengine.Request)}
PRE = [11, 12, 13, 14, 15, 16, 17, 18]          # one block of 8
#: an overload trace over three QoS classes: prompts sharing a full-block
#: prefix, long and short prompts, arrivals spread over the first steps
TRACE = [(0, PRE + [1], 20, "batch"), (1, PRE + [2, 3], 12, "interactive"),
         (1, [5] * 30, 16, "standard"), (2, PRE + [4, 2], 10, "interactive"),
         (2, [7, 8, 9], 24, "batch"), (4, list(range(1, 40)), 6, "standard"),
         (5, [3, 1], 18, "interactive"), (7, PRE + [9, 9, 1], 8, "standard")]


def _drive(pkg, policy, decode_steps, speculative=None, trace=TRACE,
           **kw):
    bed, req_cls = PKGS[pkg]
    eng = bed.FakeEngine(max_rows=3, max_len=64, block_size=8,
                         num_blocks=kw.pop("num_blocks", 9),
                         prefill_chunk=4, decode_steps=decode_steps,
                         policy=policy, speculative=speculative, **kw)
    pending = sorted(enumerate(trace), key=lambda x: x[1][0])
    reqs = []
    for _ in range(200):
        while pending and pending[0][1][0] <= eng.t:
            i, (_, prompt, n, qos) = pending.pop(0)
            reqs.append(req_cls(i, list(prompt), max_new_tokens=n, qos=qos))
            eng.submit(reqs[-1])
        eng.step()
        if not pending and not eng.queue and eng._idle():
            break
    return eng, {
        "streams": {r.id: r.out_tokens for r in reqs},
        "stamps": {r.id: (r.t_submit, r.t_admit, r.t_first, r.t_done,
                          r.n_preempted, r.error) for r in reqs},
        "t": eng.t, "n_preemptions": eng.n_preemptions,
        "prefix_hits": eng.pc.n_prefix_hits,
        "cow_copies": eng.pc.n_cow_copies,
        "prefill_tokens": eng.prefill_tokens,
        "tokens_generated": eng.tokens_generated,
        "n_host_syncs": eng.n_host_syncs,
        "spec": (eng.spec_rounds, eng.spec_drafted, eng.spec_accepted,
                 eng.spec_emitted, eng.spec_accept_mean()),
        "rejected": sorted(r.id for r in eng.rejected)}


@pytest.mark.parametrize("decode_steps", [1, 4])
@pytest.mark.parametrize("policy", [None, "edf", "edf_ec"])
def test_fake_engine_equals_reference(policy, decode_steps):
    _, want = _drive("jax", policy, decode_steps)
    eng, got = _drive("torch", policy, decode_steps)
    assert got == want
    assert want["n_preemptions"] > 0 and want["prefix_hits"] > 0
    for i, (_, prompt, n, _) in enumerate(TRACE):
        if i not in want["rejected"]:
            assert got["streams"][i] == tbed.fake_stream(prompt, n)
    eng.pc.check()


def test_fake_stream_and_scripted_draft_proposals_equal_reference():
    rng = np.random.default_rng(7)
    for _ in range(20):
        prompt = rng.integers(0, 997, int(rng.integers(1, 12))).tolist()
        n = int(rng.integers(0, 20))
        assert tbed.fake_stream(prompt, n) == jbed.fake_stream(prompt, n)
    for schedule in (None, [0], [2, 0, 4], [4, 1]):
        jd, td = jbed.ScriptedDraft(schedule), tbed.ScriptedDraft(schedule)
        for r in range(6):
            hist = rng.integers(0, 997, 5 + r).tolist()
            for row in (0, 1):
                assert td.propose(row, hist, 4) == jd.propose(row, hist, 4)


@pytest.mark.parametrize("schedule", [None, [0], [1], [4], [0, 4, 2],
                                      [4, 0], [3, 1, 2]])
def test_scripted_draft_verify_accounting_equals_reference(schedule):
    """Chosen acceptance patterns through the paged scheduler under
    preemption: the same rounds, drafted, accepted and emitted tokens,
    streams and stamps; every stream still the oracle's."""
    def spec(bed):
        return {"k": 4, "provider": bed.ScriptedDraft(schedule)}
    _, want = _drive("jax", "edf", 1, spec(jbed))
    _, got = _drive("torch", "edf", 1, spec(tbed))
    assert got == want
    assert want["spec"][0] > 0
    accepted = want["spec"][2] / max(1, want["spec"][1])
    assert (accepted == 0.0) == (schedule == [0])


# ----------------------------------------------------------------------
# instrument: counts per program name on the same traces
# ----------------------------------------------------------------------
PROMPTS = [PRE + [1], PRE + [2, 3], [5, 6, 5, 6, 5], list(range(1, 21)),
           [7, 8, 9]]


@pytest.fixture(scope="module")
def weights():
    jc, tc = config_pair("mha")
    npp = jax_params(jc, seed=0)
    return jc, tc, npp, bridged(npp, tc)


def _engines(kind, pkg, cfg, params, draft_params=None):
    eng_mod, pipe_mod, spec_mod = pkg
    dev = {} if eng_mod is jengine else {"device": "cpu"}
    paged = dict(max_rows=2, max_len=48, block_size=8, num_blocks=5,
                 decode_steps=4, prefill_chunk=8)
    slot = dict(max_batch=2, cache_len=48, decode_steps=4, prefill_chunk=8)
    if kind == "paged":
        return eng_mod.PagedServingEngine(cfg, params, **paged, **dev)
    if kind == "slot":
        return eng_mod.ServingEngine(cfg, params, **slot, **dev)
    if kind == "paged_model_draft":
        draft = spec_mod.ModelDraft(cfg, params=draft_params, **dev)
        return eng_mod.PagedServingEngine(
            cfg, params, speculative={"k": 4, "provider": draft},
            **dict(paged, num_blocks=10), **dev)
    if kind == "pipe_paged":
        return pipe_mod.PagedPipelinedEngine(cfg, params, n_stages=2,
                                             **paged, **dev)
    return pipe_mod.PipelinedEngine(cfg, params, n_stages=2, speculative=4,
                                    **slot, **dev)


@pytest.mark.parametrize("kind", ["paged", "slot", "paged_model_draft",
                                  "pipe_paged", "pipe_slot_spec"])
def test_instrument_counts_equal_reference(weights, kind):
    jc, tc, npp, tp = weights
    dj = jax_params(jc, seed=5) if kind == "paged_model_draft" else None
    dt = bridged(dj, tc) if dj is not None else None
    out = []
    for pkg, cfg, params, draft, inst, req in (
            ((jengine, jpipe, jspec), jc, npp, dj, jinst, jengine.Request),
            ((tengine, tpipe, tspec), tc, tp, dt, tinst, tengine.Request)):
        eng = _engines(kind, pkg, cfg, params, draft)
        counts = inst.instrument(eng)
        if hasattr(eng, "profile"):
            eng.profile(iters=2)
        for i, p in enumerate(PROMPTS):
            eng.submit(req(i, list(p), max_new_tokens=10))
        streams = {r.id: r.out_tokens for r in eng.run()}
        out.append((dict(counts.counts), streams,
                     {k: getattr(counts, f"{k}_dispatches")
                      for k in ("decode", "prefill", "verify", "draft",
                                "total")}, counts.per_token("total")))
    assert out[1] == out[0]
    counts = out[0][0]
    if kind == "paged":
        assert eng.n_preemptions > 0 and eng.pc.n_prefix_hits > 0
    if kind == "paged_model_draft":
        assert out[0][2]["draft"] > 0 and out[0][2]["decode"] == 0
    if kind.startswith("pipe"):
        assert counts["s0.decode"] == counts["s1.decode"] > 0
    # the port counts no kernel launch on the CPU: the plain versions run
    assert all(n == 0 for n in tinst.instrument(eng).kernel_launches.values())


def test_instrument_leaves_the_testbed_uncounted():
    """A FakeEngine makes no device call: neither package counts one."""
    for bed, inst in ((jbed, jinst), (tbed, tinst)):
        eng = bed.FakeEngine(decode_steps=4)
        counts = inst.instrument(eng)
        eng.submit(PKGS["jax" if bed is jbed else "torch"][1](
            0, [1, 2, 3], max_new_tokens=9))
        eng.run()
        assert dict(counts.counts) == {} and counts.total_dispatches == 0
