"""The port's pipelined engines against the JAX package's, on the CPU.

``PipelinedEngine`` (dense slots) and ``PagedPipelinedEngine`` (paged
pools under one ledger) split the model into 2 or 3 core stages placed
on a simulated edge network.  On the JAX model's weights (bridged into
the port) and one trace each, they must equal the live JAX pipelined
engines: token streams, ``t_*`` stamps, scheduler counters, the
simulated network's ``transfer_ms`` / ``transfer_mb`` / ``hops`` (to
1e-12) and the placements of all four strategies; and they must equal
the port's monolithic engines.  Configs: smollm MHA and GQA, falcon-mamba
(Mamba1 state rows in every stage), a Mamba1/attn hybrid, and gemma3
smoke at four layers ``(swa, swa, swa, attn)`` with the ring wrapping
(window 32, prompts of 20-90 tokens) and a stage boundary inside the swa
group; speculation (``speculative=4``) and int8 weights on smollm.  The
stage API (``Model.stage_params`` / ``run_stages``) composes to
``decode_step`` bit for bit, stage parameters are views of the
monolithic ones, and ``profile()`` in the middle of a run leaves every
stream unchanged.  float32 throughout.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_ref import CONFIGS, bridged, jax_params  # noqa: E402
from repro.config import local_global as jlocal_global  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.microservice import partition as jpart  # noqa: E402
from repro.models.quantize import bytes_per_param as jbpp  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import pipeline as jpipe  # noqa: E402
from repro_torch.config import local_global  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.microservice import partition as tpart  # noqa: E402
from repro_torch.models.quantize import bytes_per_param as tbpp  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import segment_slices  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import pipeline as tpipe  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
#: smollm's smoke reduction has 2 layers; three stages need more
DEPTH = {"mha": dict(n_layers=4, block_pattern=("attn",) * 4),
         "gqa": dict(n_layers=3, block_pattern=("attn",) * 3)}


def _pair(name):
    """(JAX config, port config): the shared smoke variants, and gemma3
    smoke at four layers (a swa group of three, then a global layer)."""
    if name == "gemma":
        return (dataclasses.replace(jsmoke("gemma3-12b"), n_layers=4,
                                    block_pattern=jlocal_global(4, 3)),
                dataclasses.replace(tsmoke("gemma3-12b"), n_layers=4,
                                    block_pattern=local_global(4, 3)))
    arch, over = CONFIGS[name]
    over = dict(over, **DEPTH.get(name, {}))
    return (dataclasses.replace(jsmoke(arch), **over),
            dataclasses.replace(tsmoke(arch), **over))


_MODELS = {}


def _model(name):
    if name not in _MODELS:
        jc, tc = _pair(name)
        npp = jax_params(jc, seed=6)
        _MODELS[name] = (jc, tc, npp, bridged(npp, tc))
    return _MODELS[name]


def _trace(name, vocab):
    rng = np.random.default_rng(31)
    if name == "gemma":   # the ring (w 32) wraps
        return [rng.integers(1, vocab, int(n)).tolist()
                for n in (20, 45, 70, 90, 33)]
    stem = rng.integers(1, vocab, 8).tolist()     # a shared full block
    return [stem + rng.integers(1, vocab, int(n)).tolist()
            for n in rng.integers(2, 11, 6)]


def _kw(name, engine):
    if engine == "paged":
        if name == "gemma":
            return dict(max_rows=3, max_len=128, block_size=16,
                        prefill_chunk=16)
        return dict(max_rows=3, max_len=32, block_size=8, num_blocks=6,
                    prefill_chunk=8)
    return dict(max_batch=3, cache_len=128 if name == "gemma" else 32,
                prefill_chunk=16 if name == "gemma" else 8)


def _drive(eng, req_cls, prompts, n=10, split_at=None, profile=False):
    """Submit every prompt and run to the end; with ``split_at``, run
    that many steps first (then ``profile()`` if asked) and resume."""
    for i, p in enumerate(prompts):
        eng.submit(req_cls(i, list(p), max_new_tokens=n))
    done = []
    if split_at is not None:
        done += eng.run(max_steps=split_at)
        if profile:
            eng.profile(iters=1)
    done = sorted(done + eng.run(), key=lambda r: r.id)
    out = {"streams": [r.out_tokens for r in done],
           "stamps": [(r.t_submit, r.t_admit, r.t_first, r.t_done)
                      for r in done],
           "rejected": [(r.id, r.t_done) for r in eng.rejected],
           "n_host_syncs": eng.n_host_syncs,
           "prefill_tokens": eng.prefill_tokens,
           "tokens_generated": eng.tokens_generated,
           "max_macro_tokens": eng.max_macro_tokens,
           "spec": (eng.spec_rounds, eng.spec_drafted, eng.spec_accepted,
                    eng.spec_emitted)}
    if hasattr(eng, "pc"):
        eng.pc.check()
        out.update(n_preemptions=eng.n_preemptions,
                   prefix_hits=eng.pc.n_prefix_hits,
                   cow=eng.pc.n_cow_copies, used_blocks=eng.pc.used_blocks)
    return out


def _net_stats(eng):
    return (eng.transfer_ms, eng.transfer_mb,
            {k: dict(v) for k, v in eng.hops.items()})


def _close(a, b, tol=1e-12):
    """transfer_ms, transfer_mb and every hop's numbers within tol."""
    assert abs(a[0] - b[0]) <= tol and abs(a[1] - b[1]) <= tol
    assert sorted(a[2]) == sorted(b[2])
    for k in a[2]:
        assert a[2][k]["count"] == b[2][k]["count"]
        for f in ("mb", "ms"):
            assert abs(a[2][k][f] - b[2][k][f]) <= tol


def _engines(engine):
    if engine == "paged":
        return (jpipe.PagedPipelinedEngine, tpipe.PagedPipelinedEngine,
                tengine.PagedServingEngine)
    return jpipe.PipelinedEngine, tpipe.PipelinedEngine, tengine.ServingEngine


#: (config, engine, stages, extra engine kwargs)
CASES = [
    ("mha", "paged", 2, {}), ("mha", "slot", 3, {}),
    ("gqa", "paged", 3, {}),
    ("mamba", "paged", 2, {}),
    ("hybrid", "paged", 3, {}), ("hybrid", "slot", 2, {}),
    ("gemma", "paged", 2, {}), ("gemma", "slot", 3, {}),
    ("mha", "paged", 2, {"speculative": 4}),
    ("mha", "slot", 3, {"speculative": 4}),
    ("gqa", "paged", 2, {"quantization": "int8"}),
]


def _case_id(case):
    name, engine, n, kw = case
    extra = "-".join(f"{k}{v}" for k, v in kw.items())
    return f"{name}-{engine}-{n}st" + (f"-{extra}" if extra else "")


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_pipelined_engines_match_jax_and_monolithic(case):
    """Streams, stamps, counters and the simulated network equal the
    live JAX pipelined engine's (round-robin placement over a seeded
    network, so every stage boundary is a real hop); streams, stamps and
    counters equal the port's monolithic engine's."""
    name, engine, n_stages, extra = case
    jc, tc, npp, tp = _model(name)
    prompts = _trace(name, jc.vocab_size)
    kw = dict(_kw(name, engine), **{"decode_steps": 4, **extra})
    jcls, tcls, mcls = _engines(engine)
    jn = jnet.make_network(np.random.default_rng(3))
    tn = tnet.make_network(np.random.default_rng(3))
    jeng = jcls(jc, npp, n_stages=n_stages, net=jn, **kw)
    teng = tcls(tc, tp, n_stages=n_stages, net=tn, device="cpu", **kw)
    jplace = jpipe.place_stages(
        jeng.to_application(np.random.default_rng(1)), jn, "round_robin")
    tplace = tpipe.place_stages(
        teng.to_application(np.random.default_rng(1)), tn, "round_robin")
    assert tplace == jplace and len(set(tplace.values())) > 1
    jeng.set_placement(jplace)
    teng.set_placement(tplace)
    assert teng.placement == jeng.placement
    want = _drive(jeng, jengine.Request, prompts)
    got = _drive(teng, tengine.Request, prompts)
    assert got == want
    _close(_net_stats(teng), _net_stats(jeng))
    assert teng.transfer_mb > 0 and teng.hops
    mono = _drive(mcls(tc, tp, device="cpu", **kw), tengine.Request, prompts)
    assert got == mono
    assert len(got["streams"]) + len(got["rejected"]) == len(prompts)
    if extra.get("speculative"):
        assert got["spec"][0] > 0
    if name == "gemma":
        assert any(len(p) + 10 > 32 for p in prompts)   # the ring wraps
    if engine == "paged" and name in ("mha", "gqa") and not extra:
        assert got["n_preemptions"] > 0 and got["prefix_hits"] > 0


@pytest.mark.parametrize("name,n_stages", [("mha", 2), ("hybrid", 3),
                                           ("gemma", 2), ("gemma", 3)])
def test_stage_ranges_partition_the_layers(name, n_stages):
    """Stage ranges tile [0, n_layers) as the reference's do; each
    stage's caches and parameters are its slice, the parameters views of
    the engine's tensors (no second copy); gemma's boundary falls inside
    its swa group."""
    jc, tc, npp, tp = _model(name)
    for cls, jcls in ((tpipe.PagedPipelinedEngine,
                       jpipe.PagedPipelinedEngine),
                      (tpipe.PipelinedEngine, jpipe.PipelinedEngine)):
        kw = _kw(name, "paged" if cls is tpipe.PagedPipelinedEngine
                 else "slot")
        eng = cls(tc, tp, n_stages=n_stages, device="cpu", **kw)
        ranges = [(s.lo, s.hi) for s in eng.stages]
        assert ranges == [(s.lo, s.hi) for s in jcls(
            jc, npp, n_stages=n_stages, **kw).stages]
        assert ranges[0][0] == 0 and ranges[-1][1] == tc.n_layers
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        full = {t.untyped_storage().data_ptr()
                for t in _tensors(eng.params)}
        for st in eng.stages:
            assert len(st.caches) == len(st.segs)
            assert [c[next(iter(c))].shape[0] for c in st.caches] == [
                s.length for s in st.segs]
            assert sum(s.length for s in st.segs) == st.hi - st.lo
            assert {t.untyped_storage().data_ptr()
                    for t in _tensors(st.params)} <= full
    if name == "gemma":
        bounds = [lo for lo, _ in ranges[1:]]
        assert any(tc.block_pattern[b - 1] == tc.block_pattern[b] == "swa"
                   for b in bounds)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


@pytest.mark.parametrize("name", ["gqa", "hybrid", "gemma"])
def test_run_stages_composes_to_decode_step(name):
    """Three decode steps through ``decode_step`` and through stages
    [0, 1), [1, 2), [2, n) chained by their (x, delta) pairs, on equal
    caches: equal logits and caches, bit for bit."""
    _, tc, _, tp = _model(name)
    m = Model(tc, device="cpu")
    b, s = 2, 64
    caches = m.init_cache(b, s)
    bounds = [(0, 1), (1, 2), (2, tc.n_layers)]
    stage_caches = [m.init_cache(b, s, layers=r) for r in bounds]
    stage_p = [m.stage_params(tp, lo, hi, entry=lo == 0,
                              exit_head=hi == tc.n_layers)
               for lo, hi in bounds]
    rng = np.random.default_rng(0)
    for step in range(3):
        tok = torch.from_numpy(rng.integers(1, tc.vocab_size, (b, 1))
                               .astype(np.int32))
        pos = torch.tensor([step, step + 5], dtype=torch.int32)
        want, _ = m.decode_step(tp, caches, {"token": tok, "pos": pos})
        x = tok
        for p, c, (lo, hi) in zip(stage_p, stage_caches, bounds):
            x = m.run_stages(p, x, lo, hi, mode="decode", pos=pos,
                             caches=c)
        assert torch.equal(x, want)
    # the stage caches, concatenated by segment, are the monolithic ones
    parts = {}
    for (lo, hi), sc in zip(bounds, stage_caches):
        for (i, _, _), c in zip(segment_slices(tc, lo, hi), sc):
            for k, v in c.items():
                parts.setdefault((i, k), []).append(v)
    assert len(parts) == sum(len(c) for c in caches)
    for (i, k), vs in parts.items():
        assert torch.equal(torch.cat(vs), caches[i][k])


@pytest.mark.parametrize("engine", ["paged", "slot"])
@pytest.mark.parametrize("name", ["mha", "mamba", "gemma"])
def test_profile_mid_run_leaves_streams_unchanged(name, engine):
    """``profile()`` after three engine steps (live rows mid-decode, KV
    and SSM state in use) and then the rest of the run: the same
    streams, stamps and counters as a run without it."""
    _, tc, _, tp = _model(name)
    prompts = _trace(name, tc.vocab_size)
    kw = dict(_kw(name, engine), decode_steps=2)
    cls = _engines(engine)[1]
    plain = _drive(cls(tc, tp, n_stages=2, device="cpu", **kw),
                   tengine.Request, prompts, split_at=3)
    eng = cls(tc, tp, n_stages=2, device="cpu", **kw)
    profiled = _drive(eng, tengine.Request, prompts, split_at=3,
                      profile=True)
    assert profiled == plain
    ms = eng.profile(iters=1)
    assert sorted(ms) == ["stage0", "stage1"] and min(ms.values()) > 0


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("fmt", [None, "int4"])
def test_place_stages_all_strategies_equal(seed, fmt):
    """``to_application`` over a fixed ``measured_ms`` and every
    placement strategy on flat and tiered networks: equal placements."""
    jc, tc, _, _ = _model("hybrid")
    jst = jpart.decompose(jc, n_core_stages=3, bytes_per_param=jbpp(fmt))
    tst = tpart.decompose(tc, n_core_stages=3, bytes_per_param=tbpp(fmt))
    measured = {"stage0": 2.5, "stage1": 0.75, "stage2": 1.25}
    for make in ("make_network", "make_tiered_network"):
        jn = getattr(jnet, make)(np.random.default_rng(seed))
        tn = getattr(tnet, make)(np.random.default_rng(seed))
        ja = jpart.to_application(jc, jst, np.random.default_rng(seed),
                                  measured_ms=measured)
        ta = tpart.to_application(tc, tst, np.random.default_rng(seed),
                                  measured_ms=measured)
        for strategy in tpipe.PLACEMENT_STRATEGIES:
            want = jpipe.place_stages(ja, jn, strategy,
                                      rng=np.random.default_rng(seed),
                                      bytes_per_param=jbpp(fmt))
            got = tpipe.place_stages(ta, tn, strategy,
                                     rng=np.random.default_rng(seed),
                                     bytes_per_param=tbpp(fmt))
            assert got == want, (make, strategy)
    with pytest.raises(ValueError):
        tpipe.place_stages(ta, tn, "lottery")


def test_pipelined_engines_default_to_cuda_and_refuse_bad_stages(
        monkeypatch):
    _, tc, _, tp = _model("mha")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tpipe.PipelinedEngine, tpipe.PagedPipelinedEngine):
        with pytest.raises(RuntimeError, match="cuda"):
            cls(tc)
        with pytest.raises(ValueError):
            cls(tc, tp, n_stages=tc.n_layers + 1, device="cpu")
    # an encoder-decoder pipelines its decoder: the plan's encoder core
    # stage is planning-only, as in the reference, and no stage runs it
    enc = dataclasses.replace(tc, is_encoder_decoder=True,
                              n_encoder_layers=2, encoder_seq=8)
    eng = tpipe.PipelinedEngine(enc, device="cpu")
    assert "encoder" in [s.name for s in eng.stage_specs]
    half = enc.n_layers // 2
    assert [(st.name, st.lo, st.hi) for st in eng.stages] == [
        ("stage0", 0, half), ("stage1", half, enc.n_layers)]
