"""The port's cross-attention and encoder-decoder against the JAX
package's, on the CPU.

``models/attention.py``'s ``cross_attention`` (a chunk through the flash
kernel's cross form, a decode step through the decode kernels at pos
``src - 1``), ``make_cross_kv`` and the paged cross view, and the cross
form's plain version, against the reference's ``cross_attention`` on the
same seeded inputs, at a source not a multiple of the block size.  The
configs of ``llama-3.2-vision-90b`` and ``seamless-m4t-medium`` and their
counters; ``decompose`` with its ``encoder`` stage; the caches and the
``cross`` group of ``PagedCache`` on one admit / release trace; the
bridge both ways.  Then, on the JAX model's weights at smoke size:
``Model.forward(mode="prefill")`` (logits and every cache leaf) against
the reference's ``Model.prefill`` for the five families of
``tests/test_paged.py::PARITY_ARCHS`` and both new ones (with a seeded
frontend, so the cross K/V are real), and K decode steps on those
caches; and both engines, unquantized and int8, and the paged pipeline
on seamless, whose streams, ``t_*`` stamps and counters must equal the
live JAX engines'.  Everything runs in float32, where the kernel
wrappers take their plain versions; tolerance 1e-5 of max(1,
|reference|) (sums in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_ref import (count_norm_calls, expected_norm_calls,  # noqa: E402
                        jax_params, t)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.microservice import partition as jpart  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models.transformer import build_segments as jsegs  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import pipeline as jpipe  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.kernels.decode_attention import paged_gather  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    paged_cross_attention_plain)
from repro_torch.microservice import partition as tpart  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import pipeline as tpipe  # noqa: E402

TOL = 1e-5
VISION, SEAMLESS = "llama-3.2-vision-90b", "seamless-m4t-medium"
CROSS_ARCHS = [VISION, SEAMLESS]
#: tests/test_paged.py's PARITY_ARCHS, and the two new families
PREFILL_ARCHS = ["smollm-360m", "mixtral-8x7b", "falcon-mamba-7b",
                 "zamba2-7b", "gemma3-12b"] + CROSS_ARCHS


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def _pair(arch, **over):
    """(JAX config, port config) of ``arch``'s smoke model."""
    return (dataclasses.replace(jget_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


def _src(cfg) -> int:
    return cfg.n_image_tokens or cfg.encoder_seq


# ----------------------------------------------------------------------
# the attention functions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_cross_attention_matches_the_reference(heads):
    """``make_cross_kv`` and ``cross_attention`` over dense K/V (a chunk
    of 7 queries through the cross form, a decode step through the dense
    decode kernel at pos src - 1), the paged cross view over shuffled
    blocks of 4 slots (13 source slots: the last block's tail is not
    read), and the cross form's plain version: each equal to the
    reference's ``cross_attention`` within 1e-5."""
    jc, tc = _pair(VISION, n_heads=heads[0], n_kv_heads=heads[1])
    rng = np.random.default_rng(3)
    p = jax.tree_util.tree_map(np.asarray, jattn.attention_init(
        jax.random.PRNGKey(3), jc, jnp.float32, cross=True))
    assert "bq" not in p
    tp = {k: t(v) for k, v in p.items()}
    b, src, bs = 3, 13, 4
    source = rng.standard_normal((b, src, jc.d_model), dtype=np.float32)
    x = rng.standard_normal((b, 7, jc.d_model), dtype=np.float32)
    jkv_ = jattn.make_cross_kv(p, jnp.asarray(source), jc)
    tkv_ = tattn.make_cross_kv(tp, t(source), tc)
    for name in ("k", "v"):
        assert _rel(tkv_[name], jkv_[name]) < TOL
    for xs, decode in ((x, False), (x[:, :1], True)):
        want = jattn.cross_attention(p, jnp.asarray(xs), jkv_, jc)
        got = tattn.cross_attention(tp, t(xs), tkv_, tc, decode=decode)
        assert got.shape == want.shape and _rel(got, want) < TOL
    # the same K/V in a paged pool, read through shuffled cross tables
    nb = -(-src // bs)
    tables = (rng.permutation(b * nb).reshape(b, nb) + 1).astype(np.int32)
    pools = {}
    for name, jn in (("k", "xk"), ("v", "xv")):
        rows = np.zeros((b, nb * bs) + tkv_[name].shape[2:], np.float32)
        rows[:, :src] = tkv_[name].numpy()
        pool = rng.standard_normal((b * nb + 1, bs) + rows.shape[2:],
                                   dtype=np.float32)
        pool[tables] = rows.reshape(b, nb, bs, *rows.shape[2:])
        pools[jn] = pool
    view = tattn.paged_cross_view({k: t(v) for k, v in pools.items()},
                                  {"cross_tables": t(tables)}, src)
    jview = jattn.paged_cross_view({k: jnp.asarray(v) for k, v in
                                    pools.items()},
                                   {"cross_tables": jnp.asarray(tables)}, src)
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            paged_gather(view[name], view["tables"])[:, :src].numpy(),
            np.asarray(jview[name]))
    for xs, decode in ((x, False), (x[:, :1], True)):
        want = jattn.cross_attention(p, jnp.asarray(xs), jview, jc)
        got = tattn.cross_attention(tp, t(xs), view, tc, decode=decode)
        assert _rel(got, want) < TOL
    # the cross form's plain version on its own: q straight in
    q = rng.standard_normal((b, 7, tc.n_heads, tc.head_dim),
                            dtype=np.float32)
    want = jnp.einsum("bngqs,bsnh->bqngh", jax.nn.softmax(
        jattn._gqa_scores(jnp.asarray(q), jview["k"], jc), axis=-1),
        jview["v"]).reshape(q.shape)
    got = paged_cross_attention_plain(t(q), view["k"], view["v"],
                                      view["tables"], src)
    assert _rel(got, want) < TOL


# ----------------------------------------------------------------------
# configs, counters, the plan, the caches, the bridge
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_configs_and_counters_match_the_reference(arch):
    """The full and smoke configs equal the reference's, and so do
    ``num_params``, the active count and the per-kind counters;
    ``decompose`` (its ``encoder`` stage for seamless) equals the
    reference's; serving, prefill and training are supported (one train
    forward of the smoke model runs with a frontend)."""
    full, jfull = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(
        jget_smoke(arch))
    assert full.num_params() == jfull.num_params()
    assert full.num_active_params() == jfull.num_active_params()
    for kind in ("attn", "cross"):
        assert full.layer_params(kind) == jfull.layer_params(kind)
        assert full.layer_active_params(kind) == jfull.layer_active_params(
            kind)
    for n in (1, 2, 3):
        got = tpart.decompose(full, n_core_stages=n)
        want = jpart.decompose(jfull, n_core_stages=n)
        assert [dataclasses.astuple(s) for s in got] == [
            dataclasses.astuple(s) for s in want]
        assert ("encoder" in [s.name for s in got]) == (arch == SEAMLESS)
    for mode in (None, "decode", "chunk", "prefill", "train"):
        ttfm.check_supported(full, mode)
    smoke = get_smoke_config(arch)
    model = Model(smoke, device="cpu")
    logits, _, _ = model.forward(
        model.init(torch.Generator().manual_seed(0)),
        {"tokens": torch.zeros((1, 4), dtype=torch.int32),
         "frontend": torch.ones((1, _src(smoke), smoke.d_model))})
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_caches_and_the_cross_ledger_match_the_reference(arch):
    """Dense and paged caches segment by segment (``xk`` / ``xv`` of a
    ``cross`` layer, and beside an encoder-decoder's ``k`` / ``v``), their
    byte count; the ``cross`` group over one admit / release trace (13
    source slots in blocks of 4: 4 blocks a row, all or nothing): free
    blocks, admissibility, tables, metas and ``check()``; sharing gated
    off; and the row reset, which zeroes exactly the row's cross
    blocks."""
    jc, tc = _pair(arch, **({"n_image_tokens": 13} if arch == VISION
                            else {"encoder_seq": 13}))
    kw = dict(max_rows=3, max_len=32, block_size=4, num_blocks=14,
              share_prefixes=True)
    jl = jkv.PagedCache(jc, **kw)
    tl = tkv.PagedCache(tc, device="cpu", **kw)
    for j_caches, t_caches in (
            (jkv.cache_struct(jc, 3, 24, jnp.float32),
             tkv.cache_struct(tc, 3, 24, torch.float32, device="cpu")),
            (jl.struct(jnp.bfloat16), tl.struct(torch.bfloat16))):
        assert len(j_caches) == len(t_caches)
        for jcache, tcache in zip(j_caches, t_caches):
            assert sorted(jcache) == sorted(tcache)
            for name in jcache:
                assert tuple(tcache[name].shape) == jcache[name].shape
                assert str(tcache[name].dtype).split(".")[-1] == str(
                    jcache[name].dtype)
    assert tkv.cache_bytes(tc, 3, 24) == jkv.cache_bytes(jc, 3, 24)
    assert (tl.nb_cross, tl.cross_src) == (jl.nb_cross, jl.cross_src) == (
        4, 13)
    assert (tl.sharing_supported, tl.share_prefixes) == (False, False)
    trace = [("admit", 0, 9), ("admit", 1, 20), ("admit", 2, 30),
             ("release", 0), ("admit", 0, 5), ("ensure", 1, 21),
             ("release", 1), ("admit", 2, 4), ("release", 2),
             ("admit", 1, 12)]
    for op, row, *n in trace:
        got = getattr(tl, op)(row, *n)
        assert got == getattr(jl, op)(row, *n), (op, row, n)
        for led in (tl, jl):
            led.check()
        assert tl.free_blocks == jl.free_blocks
        assert tl.can_admit(1) == jl.can_admit(1)
        for name in ("tables", "swa_tables", "cross_tables"):
            np.testing.assert_array_equal(getattr(tl, name),
                                          getattr(jl, name))
        for r in range(3):
            tm, jm = tl.meta(row=r), jl.meta(row=r)
            assert sorted(tm) == sorted(jm)
            for k in jm:
                np.testing.assert_array_equal(tm[k].numpy(),
                                              np.asarray(jm[k]))
    rng = np.random.default_rng(6)
    jcaches = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype)),
        jl.struct(jnp.float32))
    tcaches = [{k: t(np.asarray(v)) for k, v in c.items()} for c in jcaches]
    xids = jl.cross_tables[1].copy()
    want = jkv.paged_reset_row(jcaches, jsegs(jc), 1, jnp.asarray(xids))
    assert tkv.paged_reset_row(tcaches, ttfm.build_segments(tc), 1,
                               t(xids.astype(np.int64))) is tcaches
    for wc, tcache in zip(want, tcaches):
        for name in wc:
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(wc[name]))
    xk = next(c["xk"] for c in tcaches if "xk" in c)
    assert float(xk[:, xids].abs().sum()) == 0.0
    assert float(xk.abs().sum()) > 0.0


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_bridge_carries_the_cross_leaves_both_ways(arch):
    """``xattn`` (no bias), ``enc_xattn``, ``ln_x`` and the encoder tree
    arrive as the reference holds them and go back unchanged; the port's
    own draw has the same leaves and shapes."""
    jc, tc = _pair(arch, qkv_bias=True)
    npp = jax_params(jc, seed=2)
    tp = params_from_numpy(npp, tc, "cpu", torch.float32)
    back = params_to_numpy(tp, tc)
    flat_want = jax.tree_util.tree_leaves_with_path(npp)
    flat_got = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in flat_got] == [k for k, _ in flat_want]
    for (_, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(a, b)
    drawn = Model(tc, device="cpu").init(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda a: 0, params_to_numpy(drawn, tc))) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, npp))
    blocks = tp["blocks"]["segments"]
    if arch == VISION:
        assert sorted(blocks[1]["xattn"]) == ["wk", "wo", "wq", "wv"]
        assert "bq" in blocks[0]["attn"]
    else:
        assert {"ln_x", "enc_xattn"} <= set(blocks[0])
        assert sorted(blocks[0]["enc_xattn"]) == ["wk", "wo", "wq", "wv"]
        assert tp["encoder"]["blocks"]["segments"][0]["attn"]["wq"].shape[
            0] == tc.n_encoder_layers


@pytest.mark.parametrize("arch", CROSS_ARCHS)
@pytest.mark.parametrize("mode", ["decode", "chunk"])
def test_norm_launches_follow_the_formula(arch, mode, monkeypatch):
    """A paged decode step of 3 rows and a paged prefill chunk call the
    norm wrappers with and without a delta as often as chip_smoke.py's
    launch formula says: an encoder-decoder's decoder block one more
    (``ln_x``), a ``cross`` layer like an attn layer."""
    jc, tc = _pair(arch)
    tp = params_from_numpy(jax_params(jc, seed=4), tc, "cpu", torch.float32)
    model = Model(tc, device="cpu")
    ledger = tkv.PagedCache(tc, max_rows=3, max_len=32, block_size=8,
                            device="cpu")
    ledger.admit(1, 12)
    caches = ledger.struct(torch.float32)
    calls = count_norm_calls(monkeypatch)
    if mode == "decode":
        model.paged_decode_step(
            tp, caches, {"token": t(np.array([[3], [7], [0]], np.int32)),
                         "pos": t(np.array([4, 11, 0], np.int32))},
            ledger.meta())
    else:
        model.paged_prefill_chunk(tp, caches, t(np.arange(1, 12)[None]
                                               .astype(np.int32)), 0, 1,
                                  ledger.meta(row=1))
    assert calls == expected_norm_calls(
        tc, *((1, 0) if mode == "decode" else (0, 1)))


# ----------------------------------------------------------------------
# Model.prefill, then decode, against the reference
# ----------------------------------------------------------------------
#: prompt length, decode steps and cache length of the prefill cases:
#: 40 tokens wrap gemma3's and mixtral's smoke rings of 32 slots
PREFILL_S, PREFILL_K, PREFILL_LEN = 40, 3, 48


@pytest.fixture(scope="module")
def jax_prefill_runs():
    """One live JAX run per family, shared by its cases: the bridged
    weights, the prompt batch, the reference's ``Model.prefill`` logits
    and caches, and the logits of ``PREFILL_K`` greedy decode steps on
    those caches."""
    memo = {}

    def run(arch):
        if arch in memo:
            return memo[arch]
        jc, tc = _pair(arch)
        npp = jax_params(jc, seed=7)
        rng = np.random.default_rng(8)
        batch = {"tokens": rng.integers(1, jc.vocab_size, (2, PREFILL_S))
                 .astype(np.int32)}
        if _src(jc):
            batch["frontend"] = rng.standard_normal(
                (2, _src(jc), jc.d_model), dtype=np.float32)
        jm = build_model(jc)
        jp = jax.tree_util.tree_map(jnp.asarray, npp)
        logits, caches, _ = jm.prefill(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, PREFILL_LEN)
        steps, tok = [], np.argmax(np.asarray(logits)[:, -1, :jc.vocab_size],
                                   -1).astype(np.int32)
        dcaches = caches
        for i in range(PREFILL_K):
            lg, dcaches = jm.decode_step(jp, dcaches, {
                "token": jnp.asarray(tok[:, None]),
                "pos": jnp.full((2,), PREFILL_S + i, jnp.int32)})
            steps.append((tok, np.asarray(lg)))
            tok = np.argmax(np.asarray(lg)[:, -1, :jc.vocab_size],
                            -1).astype(np.int32)
        memo[arch] = (tc, npp, batch, np.asarray(logits),
                      jax.tree_util.tree_map(np.asarray, caches), steps)
        return memo[arch]
    return run


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_matches_the_reference(jax_prefill_runs, arch):
    """``Model.forward(mode="prefill")`` on the JAX model's weights:
    logits and every cache leaf (attn K/V seeded, rings rotated, Mamba
    state, the cross K/V of the frontend or of the encoder's output)
    within 1e-5 of the reference's ``Model.prefill``."""
    tc, npp, batch, want_logits, want_caches, _ = jax_prefill_runs(arch)
    model = Model(tc, device="cpu")
    tp = params_from_numpy(npp, tc, "cpu", torch.float32)
    caches = model.init_cache(2, PREFILL_LEN)
    logits, got, aux = model.forward(tp, {k: t(v) for k, v in batch.items()},
                                     mode="prefill", caches=caches)
    assert got is caches and float(aux["moe_aux_loss"]) == 0.0
    assert logits.shape == want_logits.shape
    assert _rel(logits, want_logits) < TOL
    assert len(got) == len(want_caches)
    for tcache, wcache in zip(got, want_caches):
        assert sorted(tcache) == sorted(wcache)
        for name in wcache:
            assert tuple(tcache[name].shape) == wcache[name].shape
            assert _rel(tcache[name], wcache[name]) < TOL, name
    if _src(tc):
        assert any(float(c[n].abs().sum()) > 0 for c in got for n in c
                   if n in ("xk", "xv"))


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_decode_after_prefill_matches_the_reference(jax_prefill_runs, arch):
    """``Model.prefill`` then ``PREFILL_K`` greedy decode steps on its
    caches (the cross layers reading the real cross K/V): each step's
    token equals the reference's and its logits are within 1e-5; and
    ``decode_steps`` over the same caches emits the same tokens."""
    tc, npp, batch, want_logits, _, steps = jax_prefill_runs(arch)
    model = Model(tc, device="cpu")
    tp = params_from_numpy(npp, tc, "cpu", torch.float32)
    tbatch = {k: t(v) for k, v in batch.items()}
    logits, caches, _ = model.prefill(tp, tbatch, PREFILL_LEN)
    tok = torch.argmax(logits[:, -1, :tc.vocab_size], -1).to(torch.int32)
    for i, (want_tok, want_lg) in enumerate(steps):
        np.testing.assert_array_equal(tok.numpy(), want_tok)
        lg, _ = model.decode_step(tp, caches, {
            "token": tok[:, None],
            "pos": torch.full((2,), PREFILL_S + i, dtype=torch.int32)})
        assert _rel(lg, want_lg) < TOL
        tok = torch.argmax(lg[:, -1, :tc.vocab_size], -1).to(torch.int32)
    _, caches, _ = model.prefill(tp, tbatch, PREFILL_LEN)
    first = torch.from_numpy(steps[0][0])
    toks = model.decode_steps(model.one_stage(tp, caches), {
        "token": first[:, None],
        "pos": torch.full((2,), PREFILL_S, dtype=torch.int32),
        "budget": torch.full((2,), PREFILL_K, dtype=torch.int32)},
        k=PREFILL_K)
    want = np.stack([s[0] for s in steps[1:]] + [np.argmax(
        steps[-1][1][:, -1, :tc.vocab_size], -1)], 1)
    np.testing.assert_array_equal(toks.numpy(), want)


# ----------------------------------------------------------------------
# the engines against the live JAX engines
# ----------------------------------------------------------------------
def _prompts(vocab):
    """Five prompts of 9-33 tokens: prefills of whole chunks of 8 and
    one token more."""
    rng = np.random.default_rng(31)
    return [rng.integers(1, vocab, int(n)).tolist()
            for n in (9, 25, 33, 17, 9)]


def _drive(eng, req_cls, prompts, n=6):
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
                   used_blocks=eng.pc.used_blocks,
                   cross_tables=eng.pc.cross_tables.tolist())
    return out


#: (family, engine, extra kwargs, pipelined): both engines unquantized
#: (the paged one with speculation asked for, which both sides gate off)
#: and int8 on each family, and the paged pipeline on seamless
ENGINE_RUNS = [
    (arch, engine, extra, False) for arch in CROSS_ARCHS
    for engine, extra in (("paged", {"speculative": 4}), ("slot", {}),
                          ("paged", {"quantization": "int8"}),
                          ("slot", {"quantization": "int8"}))] + [
    (SEAMLESS, "paged", {}, True)]


@pytest.mark.parametrize(
    "arch,engine,extra,pipelined", ENGINE_RUNS,
    ids=[f"{a.split('-')[0]}-{'pipe-' if p else ''}{e}"
         f"{'-int8' if x.get('quantization') else ''}"
         for a, e, x, p in ENGINE_RUNS])
def test_engines_match_live_jax_engines(arch, engine, extra, pipelined):
    """Five requests (9-33 tokens, 6 new each) through three rows, so
    rows are reused and each admission zeroes a reused row's cross K/V;
    K 4, chunks of 8, blocks of 8 (13 source slots: 2 cross blocks a
    row).  Streams, stamps and counters equal the JAX engine's; int8
    packs ``xattn`` / ``enc_xattn`` and the encoder's projections."""
    jc, tc = _pair(arch, **({"n_image_tokens": 13} if arch == VISION
                            else {"encoder_seq": 13}))
    npp = jax_params(jc, seed=9)
    tp = params_from_numpy(npp, tc, "cpu", torch.float32)
    prompts = _prompts(jc.vocab_size)
    kw = dict(prefill_chunk=8, decode_steps=4, **extra)
    kw.update(dict(max_rows=3, max_len=64, block_size=8)
              if engine == "paged" else dict(max_batch=3, cache_len=64))
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
        assert [st.name for st in teng.stages] == ["stage0", "stage1"]
        assert all("xk" in c for st in teng.stages for c in st.caches)
    else:
        jcls, tcls = ((jengine.PagedServingEngine, tengine.PagedServingEngine)
                      if engine == "paged" else
                      (jengine.ServingEngine, tengine.ServingEngine))
        jeng = jcls(jc, npp, **kw)
        teng = tcls(tc, tp, device="cpu", **kw)
    want = _drive(jeng, jengine.Request, prompts)
    got = _drive(teng, tengine.Request, prompts)
    assert got == want
    assert all(len(s) == 6 for s in got["streams"])
    if pipelined:
        assert abs(teng.transfer_mb - jeng.transfer_mb) <= 1e-12
        assert teng.transfer_mb > 0
    if extra.get("speculative"):
        assert got["spec_gated_off"] and teng.spec_rounds == 0
    if extra.get("quantization"):
        packed = teng.params
        blocks = packed["blocks"]["segments"]
        xattn = (blocks[1]["xattn"] if arch == VISION
                 else blocks[0]["enc_xattn"])
        assert all(isinstance(xattn[k], dict) for k in ("wq", "wk", "wv",
                                                        "wo"))
        if arch == SEAMLESS:
            assert isinstance(packed["encoder"]["blocks"]["segments"][0][
                "attn"]["wq"], dict)
