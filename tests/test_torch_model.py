"""The port's model against the live JAX model, on bridged weights.

Both packages get the same numpy inputs (``np.random.default_rng``) and
the JAX model's parameters, carried into the port by
``repro_torch.bridge``.  Everything runs in float32 on the CPU, where the
port's kernel wrappers take their plain versions.  Tolerances: 1e-5 for
attention outputs and pools, 1e-4 for hidden states and logits (a few
layers of float32 matmuls summed in another order); greedy tokens must
be equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_ref import (bridged, config_pair, count_norm_calls,  # noqa: E402
                        expected_norm_calls, jax_params, t,
                        unfused_block_apply)
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
ATTN_TOL, LOGIT_TOL = 1e-5, 1e-4
NB, BS = 6, 8                 # logical blocks per row, block size


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.fixture(scope="module", params=["mha", "gqa"])
def setup(request):
    jc, tc = config_pair(request.param)
    npp = jax_params(jc, seed=1)
    return jc, tc, npp, bridged(npp, tc)


def _pools(rng, cfg, n_layers, n_phys):
    shape = (n_layers, n_phys, BS, cfg.n_kv_heads, cfg.head_dim)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


def _layer0(tree):
    return {k: v[0] for k, v in tree.items()}


def test_configs_match_the_reference():
    from repro.configs import get_config as jget
    for name in ("mha", "gqa"):
        jc, tc = config_pair(name)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert dataclasses.asdict(jget("smollm-360m")) == dataclasses.asdict(
        get_config("smollm-360m"))


def test_bridge_copies_without_transposing(setup):
    jc, tc, npp, tp = setup
    seg = npp["blocks"]["segments"][0]
    for name, w in seg["attn"].items():
        assert torch.equal(tp["blocks"]["segments"][0]["attn"][name], t(w))
    assert torch.equal(tp["embed"]["w"], t(npp["embed"]["w"]))
    # a one-layer segment is unstacked in the reference; the bridge
    # stacks it so every segment indexes the same way
    one = dataclasses.replace(jc, n_layers=1, block_pattern=("attn",))
    npp1 = jax_params(one)
    tp1 = params_from_numpy(npp1, dataclasses.replace(
        tc, n_layers=1, block_pattern=("attn",)), "cpu", torch.float32)
    assert torch.equal(tp1["blocks"]["segments"][0]["mlp"]["w_up"][0],
                       t(npp1["blocks"]["segments"][0]["mlp"]["w_up"]))


def test_paged_decode_self_attention(setup):
    jc, tc, npp, tp = setup
    rng = np.random.default_rng(11)
    b = 4
    kp, vp = _pools(rng, jc, 1, b * NB + 1)
    kp, vp = kp[0], vp[0]
    tables = (rng.permutation(b * NB)[:b * NB].reshape(b, NB) + 1
              ).astype(np.int32)
    tables[3] = 0                                   # a masked row
    pos = np.array([0, 7, 30, 2], np.int32)
    x = rng.standard_normal((b, 1, jc.d_model), dtype=np.float32)
    jp = {k: jnp.asarray(v) for k, v in
          _layer0(npp["blocks"]["segments"][0]["attn"]).items()}
    jout, jkv = jattn.paged_decode_self_attention(
        jp, jnp.asarray(x), {"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
        {"tables": jnp.asarray(tables)}, jnp.asarray(pos), jc, "attn")
    cache = {"k": t(kp.copy()), "v": t(vp.copy())}
    tout, _ = tattn.paged_decode_self_attention(
        _layer0(tp["blocks"]["segments"][0]["attn"]), t(x), cache,
        {"tables": t(tables)}, t(pos), tc, "attn")
    assert _err(tout, jout) < ATTN_TOL
    assert _err(cache["k"], jkv["k"]) < ATTN_TOL     # the in-place write
    assert _err(cache["v"], jkv["v"]) < ATTN_TOL


@pytest.mark.parametrize("pos0", [0, 16])
def test_paged_chunk_self_attention(setup, pos0):
    jc, tc, npp, tp = setup
    rng = np.random.default_rng(12 + pos0)
    c = 9
    kp, vp = _pools(rng, jc, 1, NB + 2)
    kp, vp = kp[0], vp[0]
    table = (rng.permutation(NB + 1)[:NB] + 1).astype(np.int32)[None]
    x = rng.standard_normal((1, c, jc.d_model), dtype=np.float32)
    jp = {k: jnp.asarray(v) for k, v in
          _layer0(npp["blocks"]["segments"][0]["attn"]).items()}
    jout, jkv = jattn.paged_chunk_self_attention(
        jp, jnp.asarray(x), {"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
        {"tables": jnp.asarray(table)}, jnp.asarray([pos0], jnp.int32),
        jc, "attn")
    cache = {"k": t(kp.copy()), "v": t(vp.copy())}
    tout, _ = tattn.paged_chunk_self_attention(
        _layer0(tp["blocks"]["segments"][0]["attn"]), t(x), cache,
        {"tables": t(table)}, pos0, tc, "attn")
    assert _err(tout, jout) < ATTN_TOL
    assert _err(cache["k"], jkv["k"]) < ATTN_TOL
    assert _err(cache["v"], jkv["v"]) < ATTN_TOL


def _model_inputs(rng, jc, b):
    kp, vp = _pools(rng, jc, jc.n_layers, b * NB + 1)
    tables = (rng.permutation(b * NB)[:b * NB].reshape(b, NB) + 1
              ).astype(np.int32)
    return kp, vp, tables


def test_paged_decode_step_logits(setup):
    jc, tc, npp, tp = setup
    rng = np.random.default_rng(13)
    b = 3
    kp, vp, tables = _model_inputs(rng, jc, b)
    tok = rng.integers(0, jc.vocab_size, (b, 1)).astype(np.int32)
    pos = np.array([4, 0, 41], np.int32)
    jl, _ = build_model(jc).paged_decode_step(
        npp, [{"k": jnp.asarray(kp), "v": jnp.asarray(vp)}],
        {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)},
        {"tables": jnp.asarray(tables)})
    caches = [{"k": t(kp.copy()), "v": t(vp.copy())}]
    tl, _ = Model(tc, device="cpu").paged_decode_step(
        tp, caches, {"token": t(tok), "pos": t(pos)},
        {"tables": t(tables)})
    assert tl.shape == jl.shape
    assert _err(tl, jl) < LOGIT_TOL


@pytest.mark.parametrize("pos0", [0, 11])
def test_paged_prefill_chunk_hidden(setup, pos0):
    jc, tc, npp, tp = setup
    rng = np.random.default_rng(14 + pos0)
    kp, vp, tables = _model_inputs(rng, jc, 2)
    row, c = 1, 13
    toks = rng.integers(0, jc.vocab_size, (1, c)).astype(np.int32)
    jh, jcaches = build_model(jc).paged_prefill_chunk(
        npp, [{"k": jnp.asarray(kp), "v": jnp.asarray(vp)}],
        jnp.asarray(toks), jnp.int32(pos0), row,
        {"tables": jnp.asarray(tables[row:row + 1])})
    caches = [{"k": t(kp.copy()), "v": t(vp.copy())}]
    th, _ = Model(tc, device="cpu").paged_prefill_chunk(
        tp, caches, t(toks), pos0, row, {"tables": t(tables[row:row + 1])})
    assert _err(th, jh) < LOGIT_TOL
    assert _err(caches[0]["k"], jcaches[0]["k"]) < ATTN_TOL


@pytest.mark.parametrize("mode", ["decode", "chunk"])
def test_fused_residual_adds_keep_the_unfused_bits(setup, monkeypatch, mode):
    """A paged decode step of 3 rows and a paged prefill chunk of the
    2-layer smoke model call the norm wrappers with and without a delta
    exactly as often as chip_smoke.py's launch formula says (a decode
    iteration: every norm but the first takes a delta, the final one
    too; a chunk: no final norm), and their logits, hidden state and
    pools are bit-identical to the blocks composed as before the fusion
    (the plain norm, then each add at once)."""
    jc, tc, npp, tp = setup
    rng = np.random.default_rng(16)
    kp, vp, tables = _model_inputs(rng, jc, 3)
    tok = rng.integers(0, jc.vocab_size, (3, 1)).astype(np.int32)
    toks = rng.integers(0, jc.vocab_size, (1, 13)).astype(np.int32)
    model = Model(tc, device="cpu")

    def run():
        caches = [{"k": t(kp.copy()), "v": t(vp.copy())}]
        if mode == "decode":
            out, _ = model.paged_decode_step(
                tp, caches, {"token": t(tok), "pos": t(np.array(
                    [4, 0, 41], np.int32))}, {"tables": t(tables)})
        else:
            out, _ = model.paged_prefill_chunk(
                tp, caches, t(toks), 11, 1, {"tables": t(tables[1:2])})
        return out, caches

    calls = count_norm_calls(monkeypatch)
    got, got_caches = run()
    assert calls == expected_norm_calls(
        tc, *((1, 0) if mode == "decode" else (0, 1)))
    assert calls["norm"] == 1
    monkeypatch.setattr(ttfm, "block_apply", unfused_block_apply)
    want, want_caches = run()
    assert torch.equal(got, want)
    for name in ("k", "v"):
        assert torch.equal(got_caches[0][name], want_caches[0][name])


def test_decode_steps_tokens_with_masked_rows(setup):
    """K = 4 fused steps: row 0 runs all four, row 1 finishes after two,
    row 2 is masked from the start (budget 0, all-zero table), row 3
    takes one step.  Tokens (-1 past each budget) must be equal."""
    jc, tc, npp, tp = setup
    rng = np.random.default_rng(15)
    b = 4
    kp, vp, tables = _model_inputs(rng, jc, b)
    tables[2] = 0
    batch = {"token": rng.integers(0, jc.vocab_size, (b, 1)).astype(np.int32),
             "pos": np.array([3, 17, 9, 30], np.int32),
             "budget": np.array([4, 2, 0, 1], np.int32)}
    jt, jcaches = build_model(jc).decode_steps(
        npp, [{"k": jnp.asarray(kp), "v": jnp.asarray(vp)}],
        {k: jnp.asarray(v) for k, v in batch.items()},
        {"tables": jnp.asarray(tables)}, k=4)
    caches = [{"k": t(kp.copy()), "v": t(vp.copy())}]
    m = Model(tc, device="cpu")
    tt = m.decode_steps(m.one_stage(tp, caches),
                        {k: t(v) for k, v in batch.items()},
                        {"tables": t(tables)}, k=4)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert (tt[2] == -1).all() and (tt[1, 2:] == -1).all()
    # every block but the shared scratch block 0 holds the same KV
    assert _err(caches[0]["k"][:, 1:], jcaches[0]["k"][:, 1:]) < ATTN_TOL


# ----------------------------------------------------------------------
# dense slot caches (the ServingEngine's path)
# ----------------------------------------------------------------------
S_DENSE = 40                  # dense cache length


def _dense_caches(rng, cfg, n_layers, b):
    shape = (n_layers, b, S_DENSE, cfg.n_kv_heads, cfg.head_dim)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


def test_dense_decode_self_attention(setup):
    jc, tc, npp, tp = setup
    rng = np.random.default_rng(21)
    b = 4
    kc, vc = _dense_caches(rng, jc, 1, b)
    kc, vc = kc[0], vc[0]
    pos = np.array([0, 9, S_DENSE - 1, S_DENSE + 3], np.int32)  # last: frozen
    x = rng.standard_normal((b, 1, jc.d_model), dtype=np.float32)
    jp = {k: jnp.asarray(v) for k, v in
          _layer0(npp["blocks"]["segments"][0]["attn"]).items()}
    jout, jkv = jattn.decode_self_attention(
        jp, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        jnp.asarray(pos), jc, "attn")
    cache = {"k": t(kc.copy()), "v": t(vc.copy())}
    tout, _ = tattn.decode_self_attention(
        _layer0(tp["blocks"]["segments"][0]["attn"]), t(x), cache, t(pos),
        tc, "attn")
    assert _err(tout, jout) < ATTN_TOL
    assert _err(cache["k"], jkv["k"]) < ATTN_TOL     # the in-place write
    assert _err(cache["v"], jkv["v"]) < ATTN_TOL


@pytest.mark.parametrize("pos0", [0, 11])
def test_dense_chunk_self_attention(setup, pos0):
    jc, tc, npp, tp = setup
    rng = np.random.default_rng(22 + pos0)
    c = 9
    kc, vc = _dense_caches(rng, jc, 1, 1)
    kc, vc = kc[0], vc[0]
    x = rng.standard_normal((1, c, jc.d_model), dtype=np.float32)
    jp = {k: jnp.asarray(v) for k, v in
          _layer0(npp["blocks"]["segments"][0]["attn"]).items()}
    jout, jkv = jattn.chunk_self_attention(
        jp, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        jnp.asarray([pos0], jnp.int32), jc, "attn")
    cache = {"k": t(kc.copy()), "v": t(vc.copy())}
    tout, _ = tattn.chunk_self_attention(
        _layer0(tp["blocks"]["segments"][0]["attn"]), t(x), cache, pos0, tc,
        "attn")
    assert _err(tout, jout) < ATTN_TOL
    assert _err(cache["k"], jkv["k"]) < ATTN_TOL
    assert _err(cache["v"], jkv["v"]) < ATTN_TOL


@pytest.mark.parametrize("pos0", [0, 11])
def test_dense_prefill_chunk_touches_one_row(setup, pos0):
    """``Model.prefill_chunk`` against the reference's: the hidden state
    and the slot's cache row agree, and every other row is bit-equal to
    what it was (the reference's ``row_isolated``)."""
    jc, tc, npp, tp = setup
    rng = np.random.default_rng(23 + pos0)
    b, slot, c = 3, 1, 13
    kc, vc = _dense_caches(rng, jc, jc.n_layers, b)
    toks = rng.integers(0, jc.vocab_size, (1, c)).astype(np.int32)
    jh, jcaches = build_model(jc).prefill_chunk(
        npp, [{"k": jnp.asarray(kc), "v": jnp.asarray(vc)}],
        jnp.asarray(toks), jnp.int32(pos0), jnp.int32(slot))
    caches = [{"k": t(kc.copy()), "v": t(vc.copy())}]
    th, out = Model(tc, device="cpu").prefill_chunk(tp, caches, t(toks), pos0,
                                                    slot)
    assert out is caches
    assert _err(th, jh) < LOGIT_TOL
    assert _err(caches[0]["k"], jcaches[0]["k"]) < ATTN_TOL
    for name, a in (("k", kc), ("v", vc)):
        others = [r for r in range(b) if r != slot]
        assert torch.equal(caches[0][name][:, others], t(a[:, others]))


def test_dense_decode_steps_tokens_with_masked_rows(setup):
    """K = 4 fused dense steps: row 0 runs all four, row 1 finishes after
    two, row 2 is masked from the start (budget 0, frozen pos), row 3
    takes one step.  Tokens (-1 past each budget) and caches agree."""
    jc, tc, npp, tp = setup
    rng = np.random.default_rng(24)
    b = 4
    kc, vc = _dense_caches(rng, jc, jc.n_layers, b)
    batch = {"token": rng.integers(0, jc.vocab_size, (b, 1)).astype(np.int32),
             "pos": np.array([3, 17, 9, 30], np.int32),
             "budget": np.array([4, 2, 0, 1], np.int32)}
    jt, jcaches = build_model(jc).decode_steps(
        npp, [{"k": jnp.asarray(kc), "v": jnp.asarray(vc)}],
        {k: jnp.asarray(v) for k, v in batch.items()}, k=4)
    caches = [{"k": t(kc.copy()), "v": t(vc.copy())}]
    m = Model(tc, device="cpu")
    tt = m.decode_steps(m.one_stage(tp, caches),
                        {k: t(v) for k, v in batch.items()}, k=4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert (tt[2] == -1).all() and (tt[1, 2:] == -1).all()
    assert _err(caches[0]["k"], jcaches[0]["k"]) < ATTN_TOL
    assert _err(caches[0]["v"], jcaches[0]["v"]) < ATTN_TOL


def test_cache_struct_matches_reference(setup):
    from repro.models.kvcache import cache_bytes as jbytes
    from repro.models.kvcache import cache_struct as jstruct
    from repro_torch.models.kvcache import cache_bytes, cache_struct
    jc, tc, _, _ = setup
    want = jstruct(jc, 3, 24, jnp.float32)
    got = cache_struct(tc, 3, 24, torch.float32, device="cpu")
    assert [sorted(c) for c in got] == [sorted(c) for c in want]
    for g, w in zip(got, want):
        for name in ("k", "v"):
            assert tuple(g[name].shape) == w[name].shape
            assert not g[name].any()
    assert cache_bytes(tc, 3, 24) == jbytes(jc, 3, 24)


# ----------------------------------------------------------------------
# packed weights at the projection sites
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_projections_with_packed_weights(setup, fmt):
    """``_proj_q`` and ``mlp`` on packed int8 / int4 leaves against the
    reference's ``qdot`` sites, each side packing its own weights."""
    from repro.models import layers as jlayers
    from repro.models.quantize import quantize_params as jpack
    from repro_torch.models import layers as tlayers
    from repro_torch.models.quantize import is_quantized, quantize_params
    jc, tc, npp, tp = setup
    rng = np.random.default_rng(25)
    x = rng.standard_normal((2, 5, jc.d_model), dtype=np.float32)
    jseg = jpack(jax.tree_util.tree_map(jnp.asarray,
                                        npp["blocks"]["segments"][0]), fmt)
    tseg = quantize_params(tp["blocks"]["segments"][0], fmt)
    assert is_quantized(tseg["attn"]["wq"]) and is_quantized(
        tseg["mlp"]["w_down"])
    jl = jax.tree_util.tree_map(lambda a: a[0], jseg)
    tl = {g: {k: ({"q": v["q"][0], "s": v["s"][0]} if is_quantized(v)
                  else v[0]) for k, v in d.items()}
          for g, d in tseg.items()}
    jq_ = jattn._proj_q(jl["attn"], jnp.asarray(x), jc)
    tq_ = tattn._proj_q(tl["attn"], t(x), tc)
    assert tq_.shape == jq_.shape
    assert _err(tq_, jq_) < LOGIT_TOL
    assert _err(tlayers.mlp(tl["mlp"], t(x)),
                jlayers.mlp(jl["mlp"], jnp.asarray(x))) < LOGIT_TOL
