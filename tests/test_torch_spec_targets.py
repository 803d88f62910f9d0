"""Speculation's two draft targets, qwen2-72b and command-r-35b, against
the live JAX package at smoke size, in float32 on the CPU.

Both are pure-attention GQA decoders at hd 128 in full; each has a
feature of its own: qwen2's QKV bias and rope theta 1e6, command-r's
head tied to its embedding and rope theta 8e6.  On bridged weights:

* the rotary frequencies equal the reference's bit for bit at both
  thetas (at the smoke head size and the full one, among others), and
  ``Model.prefill``'s logits and three decode steps' logits are within
  1e-5 of the reference's;
* both engines (paged and slot) stream the live JAX engines' tokens,
  with the same ``t_*`` stamps and ``spec_*`` counters, with no draft,
  with an ``NgramDraft`` and with a smoke smollm ``ModelDraft``, K = 4,
  under preemption on the paged engine; every speculative stream equals
  the engine's plain one (greedy verification is exact).

The JAX side of each (config, engine, draft) runs once and is shared
(``jax_runs``).  The reference's own cases of these configs are
``tier2`` for their time; these are cut to 12 new tokens a request.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_ref import bridged, config_pair, jax_params, t  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config as torch_smoke  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import speculative as tspec  # noqa: E402

ARCHS = ("qwen2-72b", "command-r-35b")
LOGIT_TOL = 1e-5
PROMPTS = [[1, 2, 3, 4], [7, 8, 9], [5, 6, 5, 6, 5], [11, 3, 7, 2]]
PAGED_KW = dict(max_rows=2, max_len=48, block_size=8, num_blocks=3)
SLOT_KW = dict(max_batch=3, cache_len=48)
N_NEW = 12


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    from repro.configs import get_config as jax_config
    want, got = jax_config(arch), get_config(arch)
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "block_pattern", "qkv_bias",
                  "rope_theta", "tie_embeddings", "mlp_kind"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.n_heads // got.n_kv_heads == 8 and got.head_dim == 128
    jsm, tsm = config_pair_of(arch)
    assert dataclasses.asdict(tsm) == {
        k: v for k, v in dataclasses.asdict(jsm).items()
        if k in dataclasses.asdict(tsm)}


def config_pair_of(arch):
    return jax_smoke(arch), torch_smoke(arch)


#: (rope theta, head dim) of every registered config, full and smoke,
#: but kimi-k2-1t-a32b's full one (theta 5e4, hd 128), which no one card
#: holds: there XLA's f32 power, which is not correctly rounded, is an
#: ulp off the f64-rounded frequency at one entry of 64
ROTARY_SHAPES = sorted({(c.rope_theta, c.head_dim)
                        for a in ARCH_IDS
                        for c in (get_config(a), torch_smoke(a))
                        if c.head_dim and c.name != "kimi-k2-1t-a32b"})


@pytest.mark.parametrize("theta,head_dim", ROTARY_SHAPES)
def test_rotary_frequencies_equal_reference_bits(theta, head_dim):
    """The rotary frequencies bit for bit against the reference's jnp
    expression (an f32 ``pow`` is an ulp off at some entries; the port
    rounds the f64 power), and the rotary of unit vectors at positions
    up to 4095 within 1e-6 (cos and sin are each library's own)."""
    half = head_dim // 2
    want = np.asarray(theta ** (-jnp.arange(0, half, dtype=jnp.float32)
                                / half))
    got = tlayers._rotary_freq(theta, half, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    x = np.ones((1, 8, 1, head_dim), np.float32)
    pos = np.array([[0, 1, 7, 100, 600, 1023, 2049, 4095]], np.int32)
    want = np.asarray(jlayers.rotary(jnp.asarray(x), jnp.asarray(pos),
                                     theta))
    got = tlayers.rotary(t(x), t(pos), theta).numpy()
    assert np.max(np.abs(got - want)) < 1e-6


@pytest.fixture(scope="module")
def weights():
    memo = {}

    def get(arch):
        if arch not in memo:
            jc, tc = config_pair_of(arch)
            npp = jax_params(jc, seed=0)
            memo[arch] = (jc, tc, npp, bridged(npp, tc))
        return memo[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(weights, arch):
    jc, tc, npp, tp = weights(arch)
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, jc.vocab_size, (2, 24)).astype(np.int32)
    jm = build_model(jc)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    want, jcaches, _ = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, 40)
    model = Model(tc, device="cpu")
    got, caches, _ = model.prefill(tp, {"tokens": t(tokens)}, 40)
    assert _rel(got, want) < LOGIT_TOL
    tok = np.argmax(np.asarray(want)[:, -1, :jc.vocab_size], -1)
    for i in range(3):
        batch = {"token": tok[:, None].astype(np.int32),
                 "pos": np.full((2,), 24 + i, np.int32)}
        jlg, jcaches = jm.decode_step(
            jp, jcaches, {k: jnp.asarray(v) for k, v in batch.items()})
        lg, _ = model.decode_step(tp, caches,
                                  {k: t(v) for k, v in batch.items()})
        assert _rel(lg, jlg) < LOGIT_TOL
        tok = np.argmax(np.asarray(jlg)[:, -1, :jc.vocab_size], -1)
        assert np.array_equal(
            torch.argmax(lg[:, -1, :tc.vocab_size], -1).numpy(), tok)


# ----------------------------------------------------------------------
# both engines, three drafts, against the live JAX engines
# ----------------------------------------------------------------------
def _draft(kind, mod, draft_w, dev):
    if kind is None:
        return None
    if kind == "ngram":
        return {"k": 4, "provider": mod.NgramDraft(n=3)}
    cfg, params = draft_w
    return {"k": 4, "provider": mod.ModelDraft(cfg, params=params, **dev)}


def _run(eng, req_cls):
    if hasattr(eng, "pc"):
        # a tight pool and mid-stream admission (the reference's recipe)
        for i, p in enumerate(PROMPTS[:2]):
            eng.submit(req_cls(i, list(p), max_new_tokens=N_NEW))
        for _ in range(3):
            eng.step()
        for i, p in enumerate(PROMPTS[2:], start=2):
            eng.submit(req_cls(i, list(p), max_new_tokens=N_NEW))
    else:
        for i, p in enumerate(PROMPTS):
            eng.submit(req_cls(i, list(p), max_new_tokens=N_NEW))
    done = sorted(eng.run(), key=lambda r: r.id)
    assert len(done) == len(PROMPTS)
    return {"streams": [r.out_tokens for r in done],
            "stamps": [(r.t_submit, r.t_admit, r.t_first, r.t_done)
                       for r in done],
            "spec": (eng.spec_rounds, eng.spec_drafted, eng.spec_accepted,
                     eng.spec_emitted, eng.spec_accept_mean()),
            "n_host_syncs": eng.n_host_syncs,
            "tokens_generated": eng.tokens_generated,
            "n_preemptions": getattr(eng, "n_preemptions", None)}


def _engine(mod, engine, cfg, params, spec, dev):
    if engine == "paged":
        return mod.PagedServingEngine(cfg, params, speculative=spec,
                                      **PAGED_KW, **dev)
    return mod.ServingEngine(cfg, params, speculative=spec, **SLOT_KW, **dev)


@pytest.fixture(scope="module")
def drafts():
    """The smoke smollm draft on its own weights (seed 5), both sides."""
    jc, tc = config_pair("mha")
    npp = jax_params(jc, seed=5)
    return (jc, npp), (tc, bridged(npp, tc))


@pytest.fixture(scope="module")
def jax_runs(weights, drafts):
    memo = {}

    def get(arch, engine, draft):
        key = (arch, engine, draft)
        if key not in memo:
            jc, _, npp, _ = weights(arch)
            eng = _engine(jengine, engine, jc, npp,
                          _draft(draft, jspec, drafts[0], {}), {})
            memo[key] = _run(eng, jengine.Request)
        return memo[key]
    return get


@pytest.mark.parametrize("draft", [None, "ngram", "model"])
@pytest.mark.parametrize("engine", ["paged", "slot"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engines_match_live_jax_engines(weights, drafts, jax_runs, arch,
                                        engine, draft):
    _, tc, _, tp = weights(arch)
    want = jax_runs(arch, engine, draft)
    dev = {"device": "cpu"}
    got = _run(_engine(tengine, engine, tc, tp,
                       _draft(draft, tspec, drafts[1], dev), dev),
               tengine.Request)
    assert got == want
    if engine == "paged":
        assert want["n_preemptions"] > 0
    if draft is None:
        assert want["spec"][0] == 0
    else:
        assert want["spec"][0] > 0
        assert got["streams"] == jax_runs(arch, engine, None)["streams"]


def test_chip_smoke_spec_stream_check(weights):
    """``chip_smoke.py::check_spec_streams`` (the card's gate on
    ``qwen_spec_bf16`` against ``qwen_paged_bf16``), driven on the CPU
    with the qwen2 smoke model: equal streams pass; a stream parting
    where the plain path's top two logits are far apart fails, naming
    the row."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _, tc, _, tp = weights("qwen2-72b")
    model, cpu = Model(tc, device="cpu"), torch.device("cpu")
    prompts = {0: [1, 2, 3, 4], 1: [7, 8, 9]}
    ref = {}
    for rid, p in prompts.items():
        gap, top2, _ = cs._top2_gap(model, tp, p, cpu)
        assert gap > 0.1
        ref[rid] = [top2[0], 5]
    res = cs.check_spec_streams(model, tp, prompts, ref, ref, cpu)
    assert res["ok"] and res["rows_equal"] == 2
    got = {0: ref[0], 1: [ref[1][0] + 1, 5]}
    with pytest.raises(AssertionError, match="not a near-tie"):
        cs.check_spec_streams(model, tp, prompts, got, ref, cpu)
