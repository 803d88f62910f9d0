"""The port's engines against the live JAX engines.

Both packages' engines run in one test, on the JAX model's weights
(bridged into the port) and one trace.  For ``PagedServingEngine``:
prompts that share a full-block prefix (so the copy-on-write prefix
index maps blocks), and a pool small enough to force preemption by
recompute; on the falcon-mamba smoke model and a Mamba1/attn hybrid,
rows reused after a finished request and block-clipped macro-steps.
For ``ServingEngine``: more requests than slots, so admission waits
for whole slots.  Token streams, the ``t_admit`` /
``t_first`` / ``t_done`` stamps and the scheduler counters must be
equal — the host-side schedulers are the reference's, and the float32
model agrees with the JAX one to 1e-4 (tests/test_torch_model.py).
With ``quantization`` each side packs the same dense weights itself.
The committed golden streams are not used.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_ref import bridged, config_pair, jax_params  # noqa: E402
from repro.models.kvcache import PagedCache as JPagedCache  # noqa: E402
from repro.serving.engine import PagedServingEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JSlotEngine  # noqa: E402
from repro_torch.models.kvcache import PagedCache as TPagedCache  # noqa: E402
from repro_torch.serving.engine import PagedServingEngine as TEngine  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TSlotEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from repro_torch.serving.engine import chunk_sizes  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
ENGINE_KW = dict(max_rows=4, max_len=64, block_size=8, num_blocks=14,
                 prefill_chunk=8)
SLOT_KW = dict(max_batch=3, cache_len=64, prefill_chunk=8)
SSM_KW = dict(max_rows=3, max_len=32, block_size=8, num_blocks=6,
              prefill_chunk=8)


def _trace(vocab: int):
    rng = np.random.default_rng(21)
    stem = rng.integers(1, vocab, 16).tolist()      # two full blocks
    return [stem + rng.integers(1, vocab, int(n)).tolist()
            for n in rng.integers(2, 20, 6)]


def _short_trace(vocab: int):
    """Six prompts of 10-18 tokens behind a one-block shared stem: three
    co-run in a pool of 6 blocks until their decode growth exhausts it."""
    rng = np.random.default_rng(21)
    stem = rng.integers(1, vocab, 8).tolist()
    return [stem + rng.integers(1, vocab, int(n)).tolist()
            for n in rng.integers(2, 11, 6)]


def _drive_slots(eng, req_cls, prompts):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(i, list(p), max_new_tokens=12))
    done = sorted(eng.run(), key=lambda r: r.id)
    return {"streams": [r.out_tokens for r in done],
            "stamps": [(r.t_submit, r.t_admit, r.t_first, r.t_done)
                       for r in done],
            "n_host_syncs": eng.n_host_syncs,
            "prefill_tokens": eng.prefill_tokens,
            "tokens_generated": eng.tokens_generated,
            "max_macro_tokens": eng.max_macro_tokens,
            "rejected": [(r.id, r.t_done) for r in eng.rejected]}


def _drive(eng, req_cls, prompts):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(i, list(p), max_new_tokens=12))
    done = sorted(eng.run(), key=lambda r: r.id)
    eng.pc.check()
    return {"streams": [r.out_tokens for r in done],
            "stamps": [(r.t_submit, r.t_admit, r.t_first, r.t_done)
                       for r in done],
            "n_host_syncs": eng.n_host_syncs,
            "n_preemptions": eng.n_preemptions,
            "prefill_tokens": eng.prefill_tokens,
            "tokens_generated": eng.tokens_generated,
            "prefix_hits": eng.pc.n_prefix_hits,
            "used_blocks": eng.pc.used_blocks}


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_engine_matches_live_jax_engine(name, k):
    jc, tc = config_pair(name)
    npp = jax_params(jc, seed=2)
    prompts = _trace(jc.vocab_size)
    want = _drive(JEngine(jc, npp, decode_steps=k, **ENGINE_KW), JRequest,
                  prompts)
    got = _drive(TEngine(tc, bridged(npp, tc), decode_steps=k,
                         device="cpu", **ENGINE_KW), TRequest, prompts)
    assert got == want
    # the trace really exercised preemption and prefix sharing
    assert want["n_preemptions"] > 0 and want["prefix_hits"] > 0
    assert want["used_blocks"] == 0


class _SpyEngine(TEngine):
    """The port's paged engine, recording each macro-step's block clip
    and each row reset at admission."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.clips, self.resets = [], []

    def _grow(self, k):
        budgets, clip = super()._grow(k)
        self.clips.append(clip)
        return budgets, clip

    def _reset_row(self, row):
        self.resets.append(row)
        super()._reset_row(row)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", ["mamba", "hybrid"])
def test_ssm_engine_matches_live_jax_engine(name, k):
    """Mamba1 state rows in the paged engine: six requests through three
    rows (so rows are reused after a request finishes, and each reuse
    must start from zeroed state), a pool of 6 blocks that forces
    preemption and, at K = 4, block-clipped macro-steps (the scan length
    is capped so no row's state runs past its budget), and prefix
    sharing requested on a trace with a shared stem (gated off for SSM
    models, as in the reference)."""
    jc, tc = config_pair(name)
    npp = jax_params(jc, seed=2)
    prompts = _short_trace(jc.vocab_size)
    want = _drive(JEngine(jc, npp, decode_steps=k, prefix_sharing=True,
                          **SSM_KW), JRequest, prompts)
    eng = _SpyEngine(tc, bridged(npp, tc), decode_steps=k,
                     prefix_sharing=True, device="cpu", **SSM_KW)
    got = _drive(eng, TRequest, prompts)
    assert got == want
    assert want["n_preemptions"] > 0 and want["prefix_hits"] == 0
    assert not eng.pc.share_prefixes
    assert len(eng.resets) > len(set(eng.resets))      # a row was reused
    if k > 1:
        assert any(c is not None for c in eng.clips)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", ["mha", "gqa", "mamba", "hybrid"])
def test_slot_engine_matches_live_jax_engine(name, k):
    """ServingEngine: six requests through three slots, one of them too
    long for its slot (prompt + max_new_tokens > cache_len) and
    rejected at admission, as the reference rejects it."""
    jc, tc = config_pair(name)
    npp = jax_params(jc, seed=2)
    prompts = _trace(jc.vocab_size)
    prompts[2] = prompts[2] + list(range(1, 40))    # 53+ tokens + 12 > 64
    want = _drive_slots(JSlotEngine(jc, npp, decode_steps=k, **SLOT_KW),
                        JRequest, prompts)
    got = _drive_slots(TSlotEngine(tc, bridged(npp, tc), decode_steps=k,
                                   device="cpu", **SLOT_KW), TRequest,
                       prompts)
    assert got == want
    assert [rid for rid, _ in want["rejected"]] == [2]
    assert len(want["streams"]) == 5


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("engine", ["paged", "slot"])
def test_quantized_engines_match_live_jax_engines(engine, fmt):
    """quantization= on both engines: the same dense weights go to both
    packages, each packs its own, and streams, stamps and counters are
    equal."""
    jc, tc = config_pair("gqa")
    npp = jax_params(jc, seed=4)
    prompts = _trace(jc.vocab_size)
    if engine == "paged":
        jcls, tcls, kw, drive = JEngine, TEngine, ENGINE_KW, _drive
    else:
        jcls, tcls, kw, drive = JSlotEngine, TSlotEngine, SLOT_KW, \
            _drive_slots
    want = drive(jcls(jc, npp, decode_steps=4, quantization=fmt, **kw),
                 JRequest, prompts)
    eng = tcls(tc, bridged(npp, tc), decode_steps=4, quantization=fmt,
               device="cpu", **kw)
    assert eng.quantization == fmt
    assert eng.params["blocks"]["segments"][0]["mlp"]["w_up"]["q"].dtype == (
        torch.int8 if fmt == "int8" else torch.uint8)
    assert drive(eng, TRequest, prompts) == want


@pytest.mark.parametrize("fmt", [None, "int8"])
def test_dense_and_paged_streams_equal(fmt):
    """In the port alone, as tests/test_paged.py and test_quant.py claim
    for the reference: the slot engine and the paged engine give the
    same greedy streams at equal cache_len / max_len."""
    _, tc = config_pair("gqa")
    prompts = _trace(tc.vocab_size)
    streams = []
    for cls, kw in ((TSlotEngine, dict(max_batch=3, cache_len=64)),
                    (TEngine, dict(max_rows=3, max_len=64, block_size=8))):
        eng = cls(tc, seed=7, prefill_chunk=8, decode_steps=4,
                  quantization=fmt, device="cpu", **kw)
        for i, p in enumerate(prompts):
            eng.submit(TRequest(i, list(p), max_new_tokens=12))
        streams.append({r.id: r.out_tokens for r in eng.run()})
    assert streams[0] == streams[1] and len(streams[0]) == len(prompts)


def test_engines_refuse_speculation_and_unknown_formats():
    """Speculation is ported (tests/test_torch_spec.py); what the engines
    still refuse is a speculative setting they cannot take (a draft
    length below 1, an unknown draft kind or form), and unknown weight
    formats."""
    _, tc = config_pair("mha")
    for cls in (TSlotEngine, TEngine):
        for spec in ({"k": 0}, {"k": 2, "draft": "oracle"}, "ngram"):
            with pytest.raises(ValueError):
                cls(tc, device="cpu", speculative=spec)
        assert cls(tc, device="cpu", speculative={"k": 2}).spec.k == 2
        with pytest.raises(ValueError):
            cls(tc, device="cpu", quantization="int3")
        assert cls(tc, device="cpu", quantization="bf16").quantization is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_random_ops_match_reference(seed):
    """One random admit / ensure / release sequence on both ledgers,
    through the public API (prefix hits, copy-on-write, de-indexing):
    equal tables, queued copies and counters, and both pass check()
    after every operation."""
    jc, tc = config_pair("mha")
    kw = dict(max_rows=3, max_len=32, block_size=4, num_blocks=12,
              share_prefixes=True)
    jl, tl = JPagedCache(jc, **kw), TPagedCache(tc, **kw)
    rng = np.random.default_rng(seed)
    pos = [None] * 3
    stem = rng.integers(1, 50, 8).tolist()
    for _ in range(120):
        row = int(rng.integers(0, 3))
        if pos[row] is None:
            n = int(rng.integers(1, 14))
            toks = (stem[:int(rng.integers(0, 9))]
                    + rng.integers(1, 50, n).tolist())
            ok = jl.admit(row, len(toks) + 1, tokens=toks)
            assert tl.admit(row, len(toks) + 1, tokens=toks) == ok
            if ok:
                pos[row] = len(toks)
        elif rng.random() < 0.2:
            jl.release(row)
            tl.release(row)
            pos[row] = None
        elif rng.random() < 0.25:
            # a write into an already-covered (maybe shared) block:
            # copy-on-write, or de-indexing of an exclusive block
            p = int(rng.integers(0, pos[row] + 1))
            assert tl.ensure(row, p) == jl.ensure(row, p)
        else:
            ok = jl.ensure(row, pos[row])
            assert tl.ensure(row, pos[row]) == ok
            if ok and pos[row] < kw["max_len"] - 1:
                pos[row] += 1
        assert jl.take_pending_copies() == tl.take_pending_copies()
        np.testing.assert_array_equal(tl.tables, jl.tables)
        assert (tl.free_blocks, tl.n_prefix_hits, tl.n_cow_copies) == (
            jl.free_blocks, jl.n_prefix_hits, jl.n_cow_copies)
        jl.check()
        tl.check()


def test_paged_copy_blocks_matches_reference():
    import jax.numpy as jnp
    from repro.models.kvcache import paged_copy_blocks as jcopy
    from repro.models.transformer import build_segments as jsegs
    from repro_torch.models.kvcache import paged_copy_blocks as tcopy
    jc, tc = config_pair("gqa")
    rng = np.random.default_rng(3)
    shape = (jc.n_layers, 9, 4, jc.n_kv_heads, jc.head_dim)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    src, dst = np.array([1, 4, 2], np.int32), np.array([5, 6, 7], np.int32)
    want = jcopy([{"k": jnp.asarray(k), "v": jnp.asarray(v)}], jsegs(jc),
                 jnp.asarray(src), jnp.asarray(dst))
    caches = [{"k": torch.from_numpy(k.copy()),
               "v": torch.from_numpy(v.copy())}]
    tcopy(caches, torch.from_numpy(src).long(),
          torch.from_numpy(dst).long())
    for name in ("k", "v"):
        np.testing.assert_array_equal(caches[0][name].numpy(),
                                      np.asarray(want[0][name]))


def test_chunk_sizes_and_rejection():
    assert chunk_sizes(45, 16) == [16, 16, 8, 4, 1]
    _, tc = config_pair("mha")
    eng = TEngine(tc, device="cpu", **ENGINE_KW)
    eng.submit(TRequest(0, list(range(1, 60)), max_new_tokens=12))
    assert eng.run() == []
    assert eng.rejected[0].error and eng.rejected[0].t_done is not None
