"""The port's Mamba1 path against the JAX package's, on the CPU.

The same numpy inputs and the JAX model's parameters (bridged into the
port) go through both packages: the Mamba1 layer functions of
``repro_torch/models/ssm.py`` against ``repro/models/ssm.py``, the
falcon-mamba smoke model's chunked prefill and decode against the JAX
model's, and the state caches against the reference's.  Everything runs
in float32, where the port's scan wrapper takes its plain version.
Tolerance: 2e-5 relative to max(1, |reference|), as test_kernels.py's
float32 bound (the recurrence and the projections sum in another
order); greedy tokens must be equal.
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
from repro.models import build_model  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

TOL = 2e-5


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


@pytest.fixture(scope="module")
def setup():
    jc, tc = config_pair("mamba")
    npp = jax_params(jc, seed=1)
    return jc, tc, npp, bridged(npp, tc)


def _layer(jtree, ttree, j=0):
    """Layer ``j``'s Mamba1 params on both sides."""
    jp = {k: jnp.asarray(v[j]) for k, v in
          jtree["blocks"]["segments"][0]["mamba"].items()}
    tp = {k: v[j] for k, v in ttree["blocks"]["segments"][0]["mamba"].items()}
    return jp, tp


def _state(rng, cfg, b):
    h = rng.standard_normal((b, cfg.d_inner_eff, cfg.ssm_state),
                            dtype=np.float32)
    conv = rng.standard_normal((b, cfg.conv_width - 1, cfg.d_inner_eff),
                               dtype=np.float32)
    return h, conv


def test_configs_match_the_reference():
    from repro.configs import get_config as jget
    from repro.configs import get_smoke_config as jsmoke
    full = get_config("falcon-mamba-7b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jget("falcon-mamba-7b"))
    smoke = get_smoke_config("falcon-mamba-7b")
    assert dataclasses.asdict(smoke) == dataclasses.asdict(
        jsmoke("falcon-mamba-7b"))
    assert (full.n_layers, full.d_model, full.d_inner, full.ssm_state,
            full.conv_width, full.vocab_size, full.tie_embeddings,
            full.mlp_kind) == (64, 4096, 8192, 16, 4, 65024, False, "none")
    assert (smoke.d_model, smoke.d_inner, smoke.block_pattern,
            smoke.dtype) == (128, 256, ("mamba1", "mamba1"), "float32")


# ----------------------------------------------------------------------
# the bridge
# ----------------------------------------------------------------------
def test_bridge_carries_lm_head_and_mamba_leaves(setup):
    jc, tc, npp, tp = setup
    assert torch.equal(tp["lm_head"]["w"], t(npp["lm_head"]["w"]))
    assert not torch.equal(tp["lm_head"]["w"], tp["embed"]["w"])
    jm = npp["blocks"]["segments"][0]["mamba"]
    tm = tp["blocks"]["segments"][0]["mamba"]
    assert sorted(tm) == sorted(jm) == sorted(
        ["in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
         "A_log", "D", "out_proj"])
    for name, w in jm.items():
        assert torch.equal(tm[name], t(w)), name
    assert "ln2" not in tp["blocks"]["segments"][0]


def test_bridge_keeps_f32_leaves_of_a_bf16_model():
    """In a bf16 reference model A_log and D are float32; the bridge
    keeps them so, and every other float leaf is bf16 on both sides."""
    jc, tc = config_pair("mamba")
    jc16 = dataclasses.replace(jc, dtype="bfloat16")
    tc16 = dataclasses.replace(tc, dtype="bfloat16")
    npp = jax_params(jc16, seed=3)
    tp = params_from_numpy(npp, tc16, "cpu", torch.bfloat16)
    jm = npp["blocks"]["segments"][0]["mamba"]
    tm = tp["blocks"]["segments"][0]["mamba"]
    for name, w in jm.items():
        want = torch.float32 if name in ("A_log", "D") else torch.bfloat16
        assert tm[name].dtype == want, name
        assert str(w.dtype) == ("float32" if want == torch.float32
                                else "bfloat16"), name
        np.testing.assert_array_equal(tm[name].float().numpy(),
                                      np.asarray(w, np.float32))
    assert tp["lm_head"]["w"].dtype == torch.bfloat16


# ----------------------------------------------------------------------
# the layer functions
# ----------------------------------------------------------------------
def test_mamba1_seq_from_zero_state(setup):
    jc, tc, npp, tp = setup
    jp, tpl = _layer(npp, tp, 1)
    x = np.random.default_rng(0).standard_normal((2, 9, jc.d_model),
                                                 dtype=np.float32)
    want, (jh, jconv) = jssm.mamba1_seq(jp, jnp.asarray(x), jc)
    got, (th, tconv) = tssm.mamba1_seq(tpl, t(x), tc)
    assert _rel(got, want) < TOL
    assert _rel(th, jh) < TOL
    assert _rel(tconv, jconv) < TOL


@pytest.mark.parametrize("steps", [1, 2, 5])
def test_mamba1_seq_resumes_in_place(setup, steps):
    """A chunk resuming from carried state (T = 1 and 2 are shorter than
    the conv window): the port writes h and conv into the tensors it was
    given, and they equal the reference's returned state."""
    jc, tc, npp, tp = setup
    jp, tpl = _layer(npp, tp)
    rng = np.random.default_rng(steps)
    h, conv = _state(rng, jc, 2)
    x = rng.standard_normal((2, steps, jc.d_model), dtype=np.float32)
    want, (jh, jconv) = jssm.mamba1_seq(jp, jnp.asarray(x), jc,
                                        h0=jnp.asarray(h),
                                        conv_state=jnp.asarray(conv))
    th, tconv = t(h), t(conv)
    got, (h_out, conv_out) = tssm.mamba1_seq(tpl, t(x), tc, h0=th,
                                             conv_state=tconv)
    assert h_out is th and conv_out is tconv
    assert _rel(got, want) < TOL
    assert _rel(th, jh) < TOL
    assert _rel(tconv, jconv) < TOL


def test_mamba1_step_in_place(setup):
    jc, tc, npp, tp = setup
    jp, tpl = _layer(npp, tp)
    rng = np.random.default_rng(4)
    h, conv = _state(rng, jc, 3)
    x = rng.standard_normal((3, 1, jc.d_model), dtype=np.float32)
    want, (jh, jconv) = jssm.mamba1_step(
        jp, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(conv)), jc)
    th, tconv = t(h), t(conv)
    got, (h_out, conv_out) = tssm.mamba1_step(tpl, t(x), (th, tconv), tc)
    assert h_out is th and conv_out is tconv
    assert got.shape == (3, 1, jc.d_model)
    assert _rel(got, want) < TOL
    assert _rel(th, jh) < TOL
    assert _rel(tconv, jconv) < TOL


def test_chunks_equal_steps(setup):
    """Chunk by chunk (lengths 3, 1, 2, 6) and step by step from the
    same start give the same outputs and state."""
    jc, tc, npp, tp = setup
    _, tpl = _layer(npp, tp)
    rng = np.random.default_rng(5)
    h, conv = _state(rng, jc, 2)
    x = t(rng.standard_normal((2, 12, jc.d_model), dtype=np.float32))
    hc, cc = t(h), t(conv)
    outs, i = [], 0
    for n in (3, 1, 2, 6):
        out, _ = tssm.mamba1_seq(tpl, x[:, i:i + n], tc, h0=hc,
                                 conv_state=cc)
        outs.append(out)
        i += n
    hs, cs = t(h), t(conv)
    steps = [tssm.mamba1_step(tpl, x[:, j:j + 1], (hs, cs), tc)[0]
             for j in range(12)]
    assert _rel(torch.cat(outs, 1), torch.cat(steps, 1)) < TOL
    assert _rel(hc, hs) < TOL
    assert _rel(cc, cs) < TOL


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
def _paged_pair(jc, tc, max_rows, max_len=32, bs=8):
    jl = jkv.PagedCache(jc, max_rows=max_rows, max_len=max_len,
                        block_size=bs)
    tl = tkv.PagedCache(tc, max_rows=max_rows, max_len=max_len,
                        block_size=bs, device="cpu")
    return jl, tl


def test_cache_structs_match_reference(setup):
    jc, tc, _, _ = setup
    for j_caches, t_caches in (
            (jkv.cache_struct(jc, 3, 24, jnp.float32),
             tkv.cache_struct(tc, 3, 24, torch.float32, device="cpu")),
            (_paged_pair(jc, tc, 3)[0].struct(jnp.bfloat16),
             _paged_pair(jc, tc, 3)[1].struct(torch.bfloat16))):
        assert len(j_caches) == len(t_caches)
        for jcache, tcache in zip(j_caches, t_caches):
            assert sorted(jcache) == sorted(tcache) == ["conv", "h"]
            for name in jcache:
                assert tuple(tcache[name].shape) == jcache[name].shape
                assert str(tcache[name].dtype).split(".")[-1] == str(
                    jcache[name].dtype)
    for cfg_pair in (setup[:2], config_pair("hybrid")):
        assert tkv.cache_bytes(cfg_pair[1], 3, 24) == jkv.cache_bytes(
            cfg_pair[0], 3, 24)


def test_prefix_sharing_is_gated_off():
    jc, tc = config_pair("mamba")
    jl = jkv.PagedCache(jc, max_rows=2, max_len=32, share_prefixes=True)
    tl = tkv.PagedCache(tc, max_rows=2, max_len=32, share_prefixes=True,
                        device="cpu")
    assert (tl.sharing_supported, tl.share_prefixes) == (
        jl.sharing_supported, jl.share_prefixes) == (False, False)
    _, mha = config_pair("mha")
    assert tkv.PagedCache(mha, max_rows=2, max_len=32,
                          share_prefixes=True).share_prefixes


def test_paged_reset_row_matches_reference():
    jc, tc = config_pair("hybrid")
    jl, tl = _paged_pair(jc, tc, 3)
    rng = np.random.default_rng(6)
    jcaches = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype)),
        jl.struct(jnp.float32))
    tcaches = [{k: t(np.asarray(v)) for k, v in c.items()} for c in jcaches]
    from repro.models.transformer import build_segments as jsegs
    from repro_torch.models.transformer import build_segments as tsegs
    want = jkv.paged_reset_row(jcaches, jsegs(jc), 1)
    assert tkv.paged_reset_row(tcaches, tsegs(tc), 1) is tcaches
    for wc, tcache in zip(want, tcaches):
        for name in wc:
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(wc[name]))
    assert float(tcaches[0]["h"][:, 1].abs().sum()) == 0.0
    assert float(tcaches[0]["h"][:, 0].abs().sum()) > 0.0


@pytest.mark.parametrize("paged", [True, False])
def test_prefill_then_decode_matches_jax(setup, paged):
    """Two chunks of a prompt into row 1 of three (paged or slot), then
    one decode step of all rows: hidden states, logits and the state
    rows agree with the JAX model's; the rows the chunk does not own
    stay bit-untouched."""
    jc, tc, npp, tp = setup
    jm, tm = build_model(jc), Model(tc, device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(1, jc.vocab_size, (1, 11)).astype(np.int32)
    if paged:
        jl, tl = _paged_pair(jc, tc, 3)
        jl.admit(1, 12)
        tl.admit(1, 12)
        jcaches, tcaches = jl.struct(jnp.float32), tl.struct(torch.float32)
    else:
        jcaches = jm.init_cache(3, 32)
        tcaches = tm.init_cache(3, 32)
    # other rows hold state the chunk must not touch
    for c in tcaches:
        for a in c.values():
            a.copy_(t(rng.standard_normal(a.shape, dtype=np.float32)))
    jcaches = [{k: jnp.asarray(v.numpy()) for k, v in c.items()}
               for c in tcaches]
    before = [{k: v.clone() for k, v in c.items()} for c in tcaches]
    pos0 = 0
    for n in (8, 3):
        chunk = toks[:, pos0:pos0 + n]
        if paged:
            jx, jcaches = jm.paged_prefill_chunk(
                npp, jcaches, jnp.asarray(chunk), jnp.int32(pos0),
                jnp.int32(1), jl.meta(row=1))
            tx, _ = tm.paged_prefill_chunk(tp, tcaches, t(chunk), pos0, 1,
                                           tl.meta(row=1))
        else:
            jx, jcaches = jm.prefill_chunk(npp, jcaches, jnp.asarray(chunk),
                                           jnp.int32(pos0), jnp.int32(1))
            tx, _ = tm.prefill_chunk(tp, tcaches, t(chunk), pos0, 1)
        assert _rel(tx, jx) < TOL
        pos0 += n
    for tc_, b in zip(tcaches, before):
        for name, a in tc_.items():
            assert torch.equal(a[:, [0, 2]], b[name][:, [0, 2]])
    batch = {"token": np.array([[3], [int(toks[0, -1])], [0]], np.int32),
             "pos": np.array([4, 11, 0], np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: t(v) for k, v in batch.items()}
    if paged:
        jlog, jcaches = jm.paged_decode_step(npp, jcaches, jb, jl.meta())
        tlog, _ = tm.paged_decode_step(tp, tcaches, tb, tl.meta())
    else:
        jlog, jcaches = jm.decode_step(npp, jcaches, jb)
        tlog, _ = tm.decode_step(tp, tcaches, tb)
    assert tlog.shape == jlog.shape
    assert _rel(tlog, jlog) < TOL
    for jcache, tcache in zip(jcaches, tcaches):
        for name in tcache:
            assert _rel(tcache[name], jcache[name]) < TOL


@pytest.mark.parametrize("mode", ["decode", "chunk"])
@pytest.mark.parametrize("name", ["mamba", "hybrid"])
def test_fused_residual_adds_keep_the_unfused_bits(monkeypatch, name, mode):
    """A paged decode step of 3 rows and a paged prefill chunk of the
    falcon-mamba smoke model (2 Mamba1 layers) and of the hybrid (Mamba1,
    attn with an MLP, Mamba1) call the norm wrappers with and without a
    delta exactly as often as chip_smoke.py's launch formula says, and
    their logits, hidden state and state rows are bit-identical to the
    blocks composed as before the fusion (the plain norm, then each add
    at once)."""
    jc, tc = config_pair(name)
    tp = bridged(jax_params(jc, seed=2), tc)
    model = Model(tc, device="cpu")
    rng = np.random.default_rng(17)
    _, ledger = _paged_pair(jc, tc, 3)
    ledger.admit(1, 12)
    init = [{k: rng.standard_normal(tuple(a.shape), dtype=np.float32)
             for k, a in c.items()} for c in ledger.struct(torch.float32)]
    tok = np.array([[3], [7], [0]], np.int32)
    toks = rng.integers(1, jc.vocab_size, (1, 11)).astype(np.int32)

    def run():
        caches = [{k: t(a.copy()) for k, a in c.items()} for c in init]
        if mode == "decode":
            out, _ = model.paged_decode_step(
                tp, caches, {"token": t(tok), "pos": t(np.array(
                    [4, 11, 0], np.int32))}, ledger.meta())
        else:
            out, _ = model.paged_prefill_chunk(tp, caches, t(toks), 0, 1,
                                               ledger.meta(row=1))
        return out, caches

    calls = count_norm_calls(monkeypatch)
    got, got_caches = run()
    assert calls == expected_norm_calls(
        tc, *((1, 0) if mode == "decode" else (0, 1)))
    assert calls["norm"] == 1
    monkeypatch.setattr(ttfm, "block_apply", unfused_block_apply)
    want, want_caches = run()
    assert torch.equal(got, want)
    for got_c, want_c in zip(got_caches, want_caches):
        for k in got_c:
            assert torch.equal(got_c[k], want_c[k])


def test_untied_head_and_refusals():
    """The port's own init draws an untied head.  Training takes every
    Mamba1 mix the JAX package trains: a Mamba1 model, a Mamba1 layer
    shared by weight, a Mamba1 model beside a cross-attention block (with
    a frontend) and in an encoder-decoder (the Mamba1 block has no
    encoder cross-attention, as in the reference): the loss and every
    gradient leaf equal ``jax.value_and_grad`` of the reference's loss on
    the same weights, within 1e-5 (of max(1, |g|) for the gradients)."""
    from repro.training.train_step import loss_fn as jloss_fn
    from repro_torch.bridge import params_to_numpy
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import flatten
    jc, tc = config_pair("mamba")
    params = Model(tc, device="cpu").init(torch.Generator().manual_seed(0))
    assert params["lm_head"]["w"].shape == (tc.vocab_padded, tc.d_model)
    m = params["blocks"]["segments"][0]["mamba"]
    assert m["A_log"].dtype == torch.float32 and m["D"].dtype == torch.float32
    assert torch.equal(m["A_log"][0, 0], torch.log(
        torch.arange(1, tc.ssm_state + 1, dtype=torch.float32)))
    assert torch.all(m["dt_bias"] == -2.0)
    rng = np.random.default_rng(23)
    toks = rng.integers(0, tc.vocab_size, (2, 12)).astype(np.int32)
    frontend = rng.standard_normal((2, 5, tc.d_model)).astype(np.float32)
    for over, src in (({}, False), (dict(shared_block_kind="mamba1"), False),
                      (dict(block_pattern=("mamba1", "cross")), True),
                      (dict(block_pattern=("attn", "mamba1"),
                            is_encoder_decoder=True, n_encoder_layers=1),
                       True)):
        jcfg, tcfg = (dataclasses.replace(c, **over) for c in (jc, tc))
        ttfm.check_supported(tcfg, "train")
        npp = jax_params(jcfg, seed=4)
        batch = {"tokens": toks, **({"frontend": frontend} if src else {})}
        jm = build_model(jcfg)
        (jloss, _), jgrads = jax.value_and_grad(
            lambda p: jloss_fn(jm, p, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
            has_aux=True)(jax.tree_util.tree_map(jnp.asarray, npp))
        loss, _, grads = value_and_grad(
            Model(tcfg, device="cpu"), bridged(npp, tcfg),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        want = dict(flatten(jax.tree_util.tree_map(np.asarray, jgrads)))
        got = dict(flatten(params_to_numpy(grads, tcfg)))
        assert got.keys() == want.keys()
        for path, g in want.items():
            assert _rel(got[path], g) <= 1e-5, (over, path)


def _packed_paths(tree, prefix=()):
    """Key paths of the packed ``{"q","s"}`` leaves of a parameter tree."""
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            return [prefix]
        return [p for k, v in tree.items()
                for p in _packed_paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _packed_paths(v, prefix + (i,))]
    return []


@pytest.mark.parametrize("name", ["mamba", "hybrid"])
def test_quantization_packs_no_mamba_leaf(name):
    """int8 packs the same leaves in both packages: none of a Mamba1
    block (nor the untied head), the attn and MLP projections of a
    hybrid's attn block."""
    from repro.models import quantize as jq
    from repro_torch.models.quantize import quantize_params
    jc, tc = config_pair(name)
    npp = jax_params(jc, seed=0)
    want = _packed_paths(jq.quantize_params(
        jax.tree_util.tree_map(jnp.asarray, npp), "int8"))
    got = _packed_paths(quantize_params(bridged(npp, tc), "int8"))
    assert sorted(got, key=str) == sorted(want, key=str)
    assert not any("mamba" in p or "lm_head" in p for p in got)
    assert bool(got) == (name == "hybrid")
