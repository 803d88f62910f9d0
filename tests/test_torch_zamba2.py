"""The port's Mamba2 and weight-shared hybrid against the JAX package's,
on the CPU.

``models/ssm.py::mamba2_seq`` / ``mamba2_step`` against the reference's
on the same numpy inputs (float32, 1e-5 of max(1, |reference|): sums in
another order), at T 1, 5 and 37 resuming from a carried state and at
d_state 16 and 64; the conv state bit for bit, on inputs whose
projection is exact in any summation order.  The scan kernel's plain
version, fed Mamba2's per-head dt and A expanded over the channels,
against the reference's ``_mamba2_scan_step`` over the same steps.  The
zamba2-7b configs and counters against the reference's; the bridge
(the shared set carried once, and every shared position running on its
tensors); the caches; and then the zamba2 smoke model cut to two Mamba2
layers and two positions of the shared attn block, on the JAX model's
weights: the paged engine (rows reused), the slot engine, paged int8
and the paged pipeline in 2 stages split between the shared positions,
whose streams, ``t_*`` stamps and counters must equal the live JAX
engines'.  Everything runs in float32, where the port's kernel wrappers
take their plain versions.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_ref import (count_norm_calls, expected_norm_calls,  # noqa: E402
                        jax_params, t, unfused_block_apply)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.transformer import build_segments as jsegs  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import pipeline as jpipe  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.kernels.selective_scan import (  # noqa: E402
    selective_scan_plain)
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import pipeline as tpipe  # noqa: E402

TOL = 1e-5
ARCH = "zamba2-7b"
#: two Mamba2 layers and two positions of the shared attn block, so that
#: a 2-stage pipeline's boundary (layer 2) falls between the positions
HYBRID = dict(n_layers=4, block_pattern=("mamba2", "attn", "mamba2", "attn"))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def _pair(ds=None, **over):
    """(JAX config, port config) of the zamba2 smoke model, d_state
    ``ds`` where given."""
    if ds is not None:
        over["ssm_state"] = ds
    return (dataclasses.replace(jget_smoke(ARCH), **over),
            dataclasses.replace(get_smoke_config(ARCH), **over))


def _dyadic(rng, shape, scale):
    """Normal draws rounded to multiples of ``scale`` / 8, kept small:
    products and sums of a few hundred of them are exact in float32."""
    return (np.round(rng.standard_normal(shape) * 8) / 8 * scale).astype(
        np.float32)


def _layer_inputs(cfg, seed):
    """One Mamba2 layer's parameters (the reference's init, with A_log
    and D drawn away from their constant init values and in_proj
    dyadic) and a carried state for it."""
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in jssm.mamba2_init(
        jax.random.PRNGKey(seed), cfg, jnp.float32).items()}
    p["A_log"] = rng.standard_normal(p["A_log"].shape).astype(np.float32) / 2
    p["D"] = rng.standard_normal(p["D"].shape).astype(np.float32)
    p["in_proj"] = _dyadic(rng, p["in_proj"].shape, 1 / 16)
    return p, rng


def _state(rng, cfg, b):
    nh = cfg.d_inner_eff // cfg.mamba2_headdim
    h = rng.standard_normal((b, nh, cfg.mamba2_headdim, cfg.ssm_state),
                            dtype=np.float32)
    conv = rng.standard_normal((b, cfg.conv_width - 1, cfg.d_inner_eff),
                               dtype=np.float32)
    return h, conv


# ----------------------------------------------------------------------
# the layer functions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("steps,ds", [(1, 16), (5, 16), (37, 16), (37, 64)])
def test_mamba2_seq_resumes_in_place(steps, ds):
    """A chunk resuming from carried state (T 1 and 2 are shorter than
    the conv window): the port writes h and conv into the tensors it was
    given, h within 1e-5 and conv bit-equal to the reference's."""
    jc, tc = _pair(ds)
    p, rng = _layer_inputs(jc, steps + ds)
    h, conv = _state(rng, jc, 2)
    x = _dyadic(rng, (2, steps, jc.d_model), 1.0)
    want, (jh, jconv) = jssm.mamba2_seq(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jc,
        h0=jnp.asarray(h), conv_state=jnp.asarray(conv))
    th, tconv = t(h), t(conv)
    got, (h_out, conv_out) = tssm.mamba2_seq(
        {k: t(v) for k, v in p.items()}, t(x), tc, h0=th, conv_state=tconv)
    assert h_out is th and conv_out is tconv
    assert got.shape == (2, steps, jc.d_model)
    assert _rel(got, want) < TOL
    assert _rel(th, jh) < TOL
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))


@pytest.mark.parametrize("ds", [16, 64])
def test_mamba2_step_in_place(ds):
    jc, tc = _pair(ds)
    p, rng = _layer_inputs(jc, 40 + ds)
    h, conv = _state(rng, jc, 3)
    x = _dyadic(rng, (3, 1, jc.d_model), 1.0)
    want, (jh, jconv) = jssm.mamba2_step(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        (jnp.asarray(h), jnp.asarray(conv)), jc)
    th, tconv = t(h), t(conv)
    got, (h_out, conv_out) = tssm.mamba2_step(
        {k: t(v) for k, v in p.items()}, t(x), (th, tconv), tc)
    assert h_out is th and conv_out is tconv
    assert got.shape == (3, 1, jc.d_model)
    assert _rel(got, want) < TOL
    assert _rel(th, jh) < TOL
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))


def test_chunks_equal_steps():
    """Chunk by chunk (lengths 3, 1, 2, 6) and step by step from the
    same start give the same outputs and state (the conv state bit for
    bit)."""
    jc, tc = _pair()
    p, rng = _layer_inputs(jc, 3)
    tp = {k: t(v) for k, v in p.items()}
    h, conv = _state(rng, jc, 2)
    x = t(_dyadic(rng, (2, 12, jc.d_model), 1.0))
    hc, cc = t(h), t(conv)
    outs, i = [], 0
    for n in (3, 1, 2, 6):
        outs.append(tssm.mamba2_seq(tp, x[:, i:i + n], tc, h0=hc,
                                    conv_state=cc)[0])
        i += n
    hs, cs = t(h), t(conv)
    steps = [tssm.mamba2_step(tp, x[:, j:j + 1], (hs, cs), tc)[0]
             for j in range(12)]
    assert _rel(torch.cat(outs, 1), torch.cat(steps, 1)) < TOL
    assert _rel(hc, hs) < TOL
    assert torch.equal(cc, cs)


@pytest.mark.parametrize("ds", [16, 64])
def test_scan_with_expansions_is_the_mamba2_recurrence(ds):
    """The selective scan's plain version, with dt repeated over each
    head's channels and A over the channels and d_state, against the
    reference's ``_mamba2_scan_step`` scanned over 7 steps: the same
    decay, increment and y on the same values."""
    rng = np.random.default_rng(ds)
    b, steps, nh, hd = 2, 7, 3, 8
    dt = np.log1p(np.exp(rng.standard_normal((b, steps, nh)))).astype(
        np.float32)
    bm, cm = (rng.standard_normal((b, steps, ds), dtype=np.float32)
              for _ in range(2))
    x = rng.standard_normal((b, steps, nh, hd), dtype=np.float32)
    a_neg = -np.exp(rng.standard_normal(nh).astype(np.float32))
    h0 = rng.standard_normal((b, nh, hd, ds), dtype=np.float32)

    def step(h, inp):
        return jssm._mamba2_scan_step(h, inp, jnp.asarray(a_neg))
    want_h, ys = jax.lax.scan(step, jnp.asarray(h0), tuple(
        jnp.moveaxis(jnp.asarray(a), 1, 0) for a in (dt, bm, cm, x)))
    want_y = np.moveaxis(np.asarray(ys), 0, 1).reshape(b, steps, nh * hd)
    a_c = np.repeat(a_neg, hd)[:, None].repeat(ds, axis=1)
    y, h = selective_scan_plain(t(np.repeat(dt, hd, axis=-1)), t(bm), t(cm),
                                t(x.reshape(b, steps, nh * hd)), t(a_c),
                                t(h0.reshape(b, nh * hd, ds)))
    assert _rel(y, want_y) < TOL
    assert _rel(h.reshape(h0.shape), want_h) < TOL


# ----------------------------------------------------------------------
# configs, counters, the bridge and the caches
# ----------------------------------------------------------------------
def test_configs_and_counters_match_the_reference():
    """The full and smoke configs equal the reference's, and so do the
    counters: the shared block counted once in ``num_params``, a Mamba2
    layer's ``layer_params``; serving and training are supported (one
    train forward of the smoke model runs)."""
    full, jfull = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(get_smoke_config(ARCH)) == dataclasses.asdict(
        jget_smoke(ARCH))
    assert full.num_params() == jfull.num_params()
    assert full.num_active_params() == jfull.num_active_params()
    for kind in ("mamba2", "attn"):
        assert full.layer_params(kind) == jfull.layer_params(kind)
        assert full.layer_active_params(kind) == jfull.layer_active_params(
            kind)
    assert (full.block_pattern.count("mamba2"),
            full.block_pattern.count("attn")) == (68, 13)
    shared = sum(seg.shared for seg in ttfm.build_segments(full))
    assert shared == 13
    assert full.num_params() == (
        2 * full.vocab_size * full.d_model + full.d_model
        + 68 * full.layer_params("mamba2") + full.layer_params("attn"))
    ttfm.check_supported(full, "decode")
    ttfm.check_supported(full, "train")
    model = Model(get_smoke_config(ARCH), device="cpu")
    logits, _, _ = model.forward(
        model.init(torch.Generator().manual_seed(0)),
        {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert bool(torch.isfinite(logits).all())


@pytest.fixture(scope="module")
def hybrid():
    """The 4-layer hybrid's (JAX config, port config, the JAX model's
    numpy params, them bridged into the port)."""
    jc, tc = _pair(**HYBRID)
    npp = jax_params(jc, seed=5)
    return jc, tc, npp, params_from_numpy(npp, tc, "cpu", torch.float32)


def test_bridge_carries_the_shared_set_once(hybrid, monkeypatch):
    """The shared set arrives once, with the port's layer dim of 1, and
    both shared positions of a decode step run on its very tensors; a
    pipeline stage's slice holds the same tensors; the way back gives
    the reference's tree; Mamba2's dt_bias stays float32 in bf16."""
    jc, tc, npp, tp = hybrid
    shared = tp["blocks"]["shared"]
    assert [p is None for p in tp["blocks"]["segments"]] == [
        False, True, False, True]
    for k, v in npp["blocks"]["shared"]["attn"].items():
        assert torch.equal(shared["attn"][k], t(v)[None])
    assert sorted(tp["blocks"]["segments"][0]["mamba"]) == sorted(
        ["in_proj", "conv_w", "conv_b", "bc_proj", "dt_w", "dt_bias",
         "A_log", "D", "out_proj"])
    seen = []
    block_apply = ttfm.block_apply

    def recorded(params, *args, **kw):
        if kw["kind"] == "attn":
            seen.append(params["attn"]["wq"])
        return block_apply(params, *args, **kw)
    monkeypatch.setattr(ttfm, "block_apply", recorded)
    model = Model(tc, device="cpu")
    model.decode_step(tp, model.init_cache(2, 16), {
        "token": torch.ones((2, 1), dtype=torch.int32),
        "pos": torch.zeros(2, dtype=torch.int32)})
    assert len(seen) == 2
    assert all(w.data_ptr() == shared["attn"]["wq"].data_ptr() for w in seen)
    for lo, hi in ((0, 2), (2, 4)):
        st = model.stage_params(tp, lo, hi)
        assert st["blocks"]["shared"]["attn"]["wq"] is shared["attn"]["wq"]
    back = params_to_numpy(tp, tc)
    assert back["blocks"]["segments"][1] is None
    for k, v in npp["blocks"]["shared"]["attn"].items():
        np.testing.assert_array_equal(back["blocks"]["shared"]["attn"][k], v)
    bf = params_from_numpy(npp, dataclasses.replace(tc, dtype="bfloat16"),
                           "cpu", torch.bfloat16)
    m = bf["blocks"]["segments"][0]["mamba"]
    assert {k for k, v in m.items() if v.dtype == torch.float32} == {
        "A_log", "D", "dt_bias"}
    drawn = Model(tc, device="cpu").init(torch.Generator().manual_seed(0))
    assert drawn["blocks"]["segments"][1] is None
    for part in ("attn", "mlp"):
        assert {k: tuple(v.shape) for k, v in
                drawn["blocks"]["shared"][part].items()} == {
            k: tuple(v.shape) for k, v in shared[part].items()}
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            drawn["blocks"]["segments"][0]["mamba"].items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in
        tp["blocks"]["segments"][0]["mamba"].items()}


def test_caches_match_the_reference(hybrid):
    """Dense and paged caches, segment by segment (each shared position
    with its own KV), their byte count, the sharing gate, and the row
    reset."""
    jc, tc, _, _ = hybrid
    jl = jkv.PagedCache(jc, max_rows=3, max_len=32, block_size=8,
                        share_prefixes=True)
    tl = tkv.PagedCache(tc, max_rows=3, max_len=32, block_size=8,
                        share_prefixes=True, device="cpu")
    for j_caches, t_caches in (
            (jkv.cache_struct(jc, 3, 24, jnp.float32),
             tkv.cache_struct(tc, 3, 24, torch.float32, device="cpu")),
            (jl.struct(jnp.bfloat16), tl.struct(torch.bfloat16))):
        assert len(j_caches) == len(t_caches) == 4
        for jcache, tcache in zip(j_caches, t_caches):
            assert sorted(jcache) == sorted(tcache)
            for name in jcache:
                assert tuple(tcache[name].shape) == jcache[name].shape
                assert str(tcache[name].dtype).split(".")[-1] == str(
                    jcache[name].dtype)
    assert tkv.cache_bytes(tc, 3, 24) == jkv.cache_bytes(jc, 3, 24)
    assert (tl.sharing_supported, tl.share_prefixes) == (
        jl.sharing_supported, jl.share_prefixes) == (False, False)
    rng = np.random.default_rng(6)
    jcaches = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype)),
        jl.struct(jnp.float32))
    tcaches = [{k: t(np.asarray(v)) for k, v in c.items()} for c in jcaches]
    want = jkv.paged_reset_row(jcaches, jsegs(jc), 1)
    assert tkv.paged_reset_row(tcaches, ttfm.build_segments(tc), 1) is tcaches
    for wc, tcache in zip(want, tcaches):
        for name in wc:
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(wc[name]))
    assert float(tcaches[0]["h"][:, 1].abs().sum()) == 0.0
    assert float(tcaches[0]["h"][:, 0].abs().sum()) > 0.0


@pytest.mark.parametrize("mode", ["decode", "chunk"])
def test_fused_residual_adds_keep_the_unfused_bits(hybrid, monkeypatch,
                                                   mode):
    """A paged decode step of 3 rows and a paged prefill chunk of the
    hybrid call the norm wrappers with and without a delta as often as
    chip_smoke.py's launch formula says (the shared positions counted
    as attn layers), and give the bits of the blocks composed as before
    the fusion."""
    jc, tc, _, tp = hybrid
    model = Model(tc, device="cpu")
    rng = np.random.default_rng(17)
    ledger = tkv.PagedCache(tc, max_rows=3, max_len=32, block_size=8,
                            device="cpu")
    ledger.admit(1, 12)
    init = [{k: rng.standard_normal(tuple(a.shape), dtype=np.float32)
             for k, a in c.items()} for c in ledger.struct(torch.float32)]
    toks = rng.integers(1, jc.vocab_size, (1, 11)).astype(np.int32)

    def run():
        caches = [{k: t(a.copy()) for k, a in c.items()} for c in init]
        if mode == "decode":
            out, _ = model.paged_decode_step(
                tp, caches, {"token": t(np.array([[3], [7], [0]], np.int32)),
                             "pos": t(np.array([4, 11, 0], np.int32))},
                ledger.meta())
        else:
            out, _ = model.paged_prefill_chunk(tp, caches, t(toks), 0, 1,
                                               ledger.meta(row=1))
        return out, caches

    calls = count_norm_calls(monkeypatch)
    got, got_caches = run()
    assert calls == expected_norm_calls(
        tc, *((1, 0) if mode == "decode" else (0, 1)))
    monkeypatch.setattr(ttfm, "block_apply", unfused_block_apply)
    want, want_caches = run()
    assert torch.equal(got, want)
    for got_c, want_c in zip(got_caches, want_caches):
        for k in got_c:
            assert torch.equal(got_c[k], want_c[k])


# ----------------------------------------------------------------------
# the engines against the live JAX engines
# ----------------------------------------------------------------------
def _prompts(vocab):
    """Five prompts of 17-65 tokens: prefills of whole chunks of 16 and
    one token more."""
    rng = np.random.default_rng(29)
    return [rng.integers(1, vocab, int(n)).tolist()
            for n in (17, 49, 65, 33, 17)]


def _drive(eng, req_cls, prompts, n=8):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(i, list(p), max_new_tokens=n))
    done = sorted(eng.run(), key=lambda r: r.id)
    out = {"streams": [r.out_tokens for r in done],
           "stamps": [(r.t_submit, r.t_admit, r.t_first, r.t_done)
                      for r in done],
           "n_host_syncs": eng.n_host_syncs,
           "prefill_tokens": eng.prefill_tokens,
           "tokens_generated": eng.tokens_generated,
           "spec_gated_off": eng.spec_gated_off}
    if hasattr(eng, "pc"):
        eng.pc.check()
        out.update(n_preemptions=eng.n_preemptions,
                   used_blocks=eng.pc.used_blocks)
    return out


#: (engine, extra kwargs, pipelined): the paged engine with speculation
#: asked for (which both sides gate off: Mamba state cannot be rolled
#: back), the slot engine, int8 weights (the shared block's projections
#: packed) and the paged pipeline across the shared boundary
RUNS = [("paged", {"speculative": 4}, False), ("slot", {}, False),
        ("paged", {"quantization": "int8"}, False), ("paged", {}, True)]


@pytest.mark.parametrize("engine,extra,pipelined", RUNS,
                         ids=["paged", "slot", "paged-int8", "pipe-paged"])
def test_engines_match_live_jax_engines(hybrid, engine, extra, pipelined):
    """Five requests (17-65 tokens, 8 new each) through three rows, so
    rows are reused; K 4, chunks of 16.  The pipelined engines run 2
    stages placed round-robin over a seeded network, stage 0 on layers
    0-1 and stage 1 on 2-3, each with one shared position on the one
    shared set.  Streams, stamps and counters equal the JAX engine's."""
    jc, tc, npp, tp = hybrid
    prompts = _prompts(jc.vocab_size)
    kw = dict(prefill_chunk=16, decode_steps=4, **extra)
    kw.update(dict(max_rows=3, max_len=128, block_size=16)
              if engine == "paged" else dict(max_batch=3, cache_len=128))
    if pipelined:
        jn = jnet.make_network(np.random.default_rng(3))
        tn = tnet.make_network(np.random.default_rng(3))
        jeng = jpipe.PagedPipelinedEngine(jc, npp, n_stages=2, net=jn, **kw)
        teng = tpipe.PagedPipelinedEngine(tc, tp, n_stages=2, net=tn,
                                          device="cpu", **kw)
        jplace = jpipe.place_stages(
            jeng.to_application(np.random.default_rng(1)), jn, "round_robin")
        tplace = tpipe.place_stages(
            teng.to_application(np.random.default_rng(1)), tn, "round_robin")
        assert tplace == jplace and len(set(tplace.values())) > 1
        jeng.set_placement(jplace)
        teng.set_placement(tplace)
        assert [(st.lo, st.hi) for st in teng.stages] == [(0, 2), (2, 4)]
        wq = teng.params["blocks"]["shared"]["attn"]["wq"]
        for st in teng.stages:
            assert sum(seg.shared for seg in st.segs) == 1
            assert st.params["blocks"]["shared"]["attn"]["wq"] is wq
    else:
        jcls, tcls = ((jengine.PagedServingEngine, tengine.PagedServingEngine)
                      if engine == "paged" else
                      (jengine.ServingEngine, tengine.ServingEngine))
        jeng = jcls(jc, npp, **kw)
        teng = tcls(tc, tp, device="cpu", **kw)
    want = _drive(jeng, jengine.Request, prompts)
    got = _drive(teng, tengine.Request, prompts)
    assert got == want
    assert all(len(s) == 8 for s in got["streams"])
    if pipelined:
        assert abs(teng.transfer_mb - jeng.transfer_mb) <= 1e-12
        assert teng.transfer_mb > 0
    if extra.get("speculative"):
        assert got["spec_gated_off"] and teng.spec_rounds == 0
    if extra.get("quantization"):
        packed = quantize_params(tp, "int8")["blocks"]
        assert isinstance(packed["shared"]["attn"]["wq"], dict)
        assert all(isinstance(v, torch.Tensor) for v in
                   packed["segments"][0]["mamba"].values())
