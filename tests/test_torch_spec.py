"""The port's draft-verify speculative decoding against the live JAX
package, on bridged weights, in float32 on the CPU.

* The batched paged-chunk attention's plain version: bit-equal to B
  one-row calls, and within 1e-5 of the reference's jnp chunk attention
  (float32 sums in another order, as tests/test_torch_kernels.py).
* ``greedy_verify_update`` and ``Model.verify_steps``' ``emit``: equal
  to the reference's exactly; the KV that ``verify_steps`` writes at the
  emitted positions within 1e-6 in the first layer (one projection and
  rotary of the embedded tokens, float32 values of unit size summed in
  another order) and 1e-5 in every layer (a deeper layer's K/V comes
  from hidden states that already differ in their last bits, the
  tolerance tests/test_torch_model.py holds pools to).
* The engines under ``speculative=``: streams, ``t_*`` stamps, the
  ``spec_*`` counters and ``n_host_syncs`` equal to the live JAX
  engines' (the paged engine under preemption and mid-stream admission
  at K = 1, 4, 8; the slot engine; int8 weights; a model draft).
* The draft providers and ``SpecConfig.make``: the same proposals and
  the same errors as the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_ref import bridged, config_pair, jax_params, t  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.model import greedy_verify_update as j_verify  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
from repro.serving.engine import PagedServingEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JSlotEngine  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    paged_chunk_attention, paged_chunk_attention_plain,
    paged_prefill_attention_plain)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.model import greedy_verify_update as t_verify  # noqa: E402
from repro_torch.serving import speculative as tspec  # noqa: E402
from repro_torch.serving.engine import PagedServingEngine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TSlotEngine  # noqa: E402

ATTN_TOL, KV_TOL = 1e-5, 1e-6
NB, BS = 6, 8                 # logical blocks per row, block size
#: the reference's speculative recipe (tests/test_speculative.py), with
#: a pool of 4 blocks: on these weights its 10 do not preempt, 4 do at
#: every K
PROMPTS = [[1, 2, 3, 4], [7, 8, 9], [5, 6, 5, 6, 5], [11, 3, 7, 2]]
PAGED_KW = dict(max_rows=2, max_len=48, block_size=8, num_blocks=4)
SLOT_KW = dict(max_batch=3, cache_len=48)


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.fixture(scope="module")
def gqa():
    jc, tc = config_pair("gqa")
    npp = jax_params(jc, seed=3)
    return jc, tc, npp, bridged(npp, tc)


def _chunk_inputs(rng, b, c, h, kv, d, nb=NB, bs=BS):
    """q (B,C,H,D); pools (B*nb+1, bs, KV, D); distinct tables over blocks
    1..; positions spread, the last row's pos + C past max_len (clamped
    keys).  Row 0's blocks do not cover its pos + C: from the block of
    its last query on, its table points at the scratch block 0."""
    nbp = b * nb + 1
    q = rng.standard_normal((b, c, h, d), dtype=np.float32)
    kp = rng.standard_normal((nbp, bs, kv, d), dtype=np.float32)
    vp = rng.standard_normal((nbp, bs, kv, d), dtype=np.float32)
    tables = (rng.permutation(nbp - 1)[:b * nb].reshape(b, nb) + 1
              ).astype(np.int32)
    pos = rng.integers(0, nb * bs, size=b).astype(np.int32)
    pos[-1] = nb * bs - 2
    tables[0, min(pos[0] + c - 1, nb * bs - 1) // bs:] = 0
    return q, kp, vp, tables, pos


# ----------------------------------------------------------------------
# the batched paged-chunk attention (plain version)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,c,h,kv,d", [(4, 5, 6, 2, 32), (3, 9, 4, 4, 16),
                                        (8, 5, 15, 5, 64), (1, 2, 6, 2, 32)])
def test_batched_plain_is_one_row_plain_per_row(b, c, h, kv, d):
    rng = np.random.default_rng(30 + b * c)
    q, kp, vp, tables, pos = map(t, _chunk_inputs(rng, b, c, h, kv, d))
    got = paged_chunk_attention_plain(q, kp, vp, tables, pos)
    assert got.shape == q.shape
    for row in range(b):
        want = paged_prefill_attention_plain(q[row], kp, vp, tables[row],
                                             int(pos[row]))
        assert torch.equal(got[row], want)


@pytest.mark.parametrize("h,kv", [(6, 2), (4, 4)])
def test_batched_plain_matches_reference_chunk_attention(h, kv):
    """The reference's linear branch of paged_chunk_self_attention (the
    gather, _gqa_scores, kpos <= qpos mask, softmax, _gqa_out; an
    identity wo leaves the projection exact) for B rows at their own
    positions."""
    b, c, d = 4, 5, 32
    rng = np.random.default_rng(40 + h)
    q, kp, vp, tables, pos = _chunk_inputs(rng, b, c, h, kv, d)
    got = paged_chunk_attention_plain(t(q), t(kp), t(vp), t(tables), t(pos))

    class Cfg:
        n_heads, n_kv_heads, head_dim = h, kv, d
    jt = jnp.asarray(tables)
    kg = jattn._paged_gather(jnp.asarray(kp), jt)
    vg = jattn._paged_gather(jnp.asarray(vp), jt)
    scores = jattn._gqa_scores(jnp.asarray(q), kg, Cfg)
    qpos = (jnp.asarray(pos)[:, None] + jnp.arange(c)[None, :])[
        :, None, :, None]
    kpos = jnp.arange(NB * BS)[None, None, None, :]
    mask = jnp.where(kpos <= qpos, 0.0, jattn.NEG_INF).astype(jnp.float32)
    probs = jax.nn.softmax(scores + mask[:, :, None], axis=-1)
    want = jattn._gqa_out(probs, vg, {"wo": jnp.eye(h * d)}, Cfg,
                          jnp.float32)
    assert _err(got, np.asarray(want).reshape(b, c, h, d)) < ATTN_TOL


def test_batched_wrapper_refuses_without_a_launch():
    """Off the CPU the wrapper checks devices, shapes and dtypes before any
    launch (here on meta tensors, which no kernel takes)."""
    _build.reset_launches()
    q = torch.empty((2, 5, 6, 32), device="meta")
    pool = torch.empty((9, 8, 2, 32), device="meta")
    tables = torch.empty((2, 4), dtype=torch.int32, device="meta")
    pos = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        paged_chunk_attention(q, pool, pool, tables, pos)
    with pytest.raises(ValueError):
        paged_chunk_attention(q, pool, pool, tables, pos[:1])
    assert _build.launches["paged_chunk_attention"] == 0
    assert all(n == 0 for n in _build.bodies["paged_chunk_attention"].values())


@pytest.mark.parametrize("paged", [True, False])
def test_b_row_chunk_self_attention(gqa, paged):
    """The model's chunk attention with a (B,) pos tensor against the
    reference's, paged and dense: outputs, and the caches written in
    place (slots clamped at max_len - 1, writes past a row's covered
    blocks in the scratch block)."""
    jc, tc, npp, tp = gqa
    rng = np.random.default_rng(50 + paged)
    b, c = 3, 5
    kv, hd = jc.n_kv_heads, jc.head_dim
    x = rng.standard_normal((b, c, jc.d_model), dtype=np.float32)
    pos = np.array([4, 0, NB * BS - 3], np.int32)
    layer = {k: v[0] for k, v in npp["blocks"]["segments"][0]["attn"].items()}
    tlayer = {k: v[0] for k, v in tp["blocks"]["segments"][0]["attn"].items()}
    jp = {k: jnp.asarray(v) for k, v in layer.items()}
    if paged:
        nbp = b * NB + 1
        kc = rng.standard_normal((nbp, BS, kv, hd), dtype=np.float32)
        vc = rng.standard_normal((nbp, BS, kv, hd), dtype=np.float32)
        tables = (rng.permutation(nbp - 1)[:b * NB].reshape(b, NB) + 1
                  ).astype(np.int32)
        tables[0, 1:] = 0
        jout, jkv = jattn.paged_chunk_self_attention(
            jp, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
            {"tables": jnp.asarray(tables)}, jnp.asarray(pos), jc, "attn")
        cache = {"k": t(kc.copy()), "v": t(vc.copy())}
        tout, _ = tattn.paged_chunk_self_attention(
            tlayer, t(x), cache, {"tables": t(tables)}, t(pos), tc, "attn")
        # the scratch block takes duplicate writes in no set order
        keep = slice(1, None)
    else:
        s = NB * BS
        kc = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
        vc = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
        jout, jkv = jattn.chunk_self_attention(
            jp, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
            jnp.asarray(pos), jc, "attn")
        cache = {"k": t(kc.copy()), "v": t(vc.copy())}
        tout, _ = tattn.chunk_self_attention(tlayer, t(x), cache, t(pos), tc,
                                             "attn")
        keep = slice(None)
    assert _err(tout, jout) < ATTN_TOL
    # a row's clamped last slot takes duplicate writes too: compare the
    # slots below it
    for name in ("k", "v"):
        got, want = cache[name].numpy(), np.asarray(jkv[name])
        if paged:
            assert _err(got[keep], want[keep]) < ATTN_TOL
        else:
            assert _err(got[:, :-1], want[:, :-1]) < ATTN_TOL


# ----------------------------------------------------------------------
# greedy verification
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["full", "first_mismatch", "budget0",
                                  "short_budget", "random"])
def test_greedy_verify_update_matches_reference(case):
    rng = np.random.default_rng(60)
    b, s, vocab, v_pad = 5, 5, 40, 48
    logits = rng.standard_normal((b, s, v_pad), dtype=np.float32)
    logits[:, :, vocab:] = 10.0          # padding never wins the argmax
    g = logits[:, :, :vocab].argmax(-1).astype(np.int32)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    budget = np.full(b, s, np.int32)
    if case in ("full", "budget0", "short_budget"):
        tokens[:, 1:] = g[:, :-1]        # every draft is the greedy target
    if case == "first_mismatch":
        tokens[:, 1:] = g[:, :-1]
        tokens[:, 1] = (g[:, 0] + 1) % vocab
    if case == "budget0":
        budget[[0, 3]] = 0
    if case == "short_budget":
        budget[:] = [1, 2, 3, 4, 0]
    if case == "random":
        tokens[:2, 1:] = g[:2, :-1]
        tokens[2, 1:3] = g[2, :2]
        budget[:] = rng.integers(0, s + 1, b)
    want = np.asarray(j_verify(jnp.asarray(logits), jnp.asarray(tokens),
                               jnp.asarray(budget), vocab))
    got = t_verify(t(logits), t(tokens), t(budget), vocab)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    n_emit = (want >= 0).sum(1)
    if case == "full":
        assert (n_emit == s).all()
    if case == "first_mismatch":
        assert (n_emit == 1).all()
    if case == "budget0":
        assert n_emit[0] == n_emit[3] == 0
    if case == "short_budget":
        assert n_emit.tolist() == [1, 2, 3, 4, 0]


@pytest.mark.parametrize("paged", [True, False])
def test_verify_steps_matches_reference(gqa, paged):
    """``Model.verify_steps`` against the reference's on bridged weights:
    emit exactly, the written KV within 1e-6 at each row's emitted
    positions.  Drafts are the target's own greedy tokens on two rows (so
    some rows accept all of them), random elsewhere; one row has budget
    0, one a budget below K + 1."""
    jc, tc, npp, tp = gqa
    rng = np.random.default_rng(70 + paged)
    b, s = 4, 5
    jmodel, tmodel = build_model(jc), Model(tc, device="cpu")
    kv, hd, nl = jc.n_kv_heads, jc.head_dim, jc.n_layers
    pos = np.array([9, 0, 23, 30], np.int32)
    budget = np.array([5, 3, 0, 5], np.int32)
    tokens = rng.integers(1, jc.vocab_size, (b, s)).astype(np.int32)
    if paged:
        nbp = b * NB + 1
        shape = (nl, nbp, BS, kv, hd)
        tables = (rng.permutation(nbp - 1)[:b * NB].reshape(b, NB) + 1
                  ).astype(np.int32)
        meta_j = {"tables": jnp.asarray(tables)}
        meta_t = {"tables": t(tables)}
    else:
        shape = (nl, b, NB * BS, kv, hd)
        meta_j = meta_t = None
    kc = rng.standard_normal(shape, dtype=np.float32)
    vc = rng.standard_normal(shape, dtype=np.float32)

    def run_j(tok, bud):
        return jmodel.verify_steps(
            npp, [{"k": jnp.asarray(kc), "v": jnp.asarray(vc)}],
            {"token": jnp.asarray(tok), "pos": jnp.asarray(pos),
             "budget": jnp.asarray(bud)}, meta_j)
    # rows 0 and 3 draft the target's own greedy tokens, one by one (the
    # target is causal: g[:, j - 1] depends on tokens[:, :j] only)
    for j in range(1, s):
        g = np.asarray(run_j(tokens, np.full(b, s, np.int32))[0])
        tokens[[0, 3], j] = g[[0, 3], j - 1]
    want, jcaches = run_j(tokens, budget)
    caches = [{"k": t(kc.copy()), "v": t(vc.copy())}]
    got = tmodel.verify_steps(tmodel.one_stage(tp, caches), {
        "token": t(tokens), "pos": t(pos), "budget": t(budget)}, meta_t)
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy(), want)
    n_emit = (want >= 0).sum(1)
    assert n_emit[0] == s and n_emit[2] == 0
    for name in ("k", "v"):
        a, w = caches[0][name].numpy(), np.asarray(jcaches[0][name])
        for row in range(b):
            for j in range(int(n_emit[row])):
                p = int(pos[row]) + j
                got_kv, want_kv = ((a[:, tables[row, p // BS], p % BS],
                                    w[:, tables[row, p // BS], p % BS])
                                   if paged else (a[:, row, p], w[:, row, p]))
                assert _err(got_kv[0], want_kv[0]) < KV_TOL
                assert _err(got_kv, want_kv) < ATTN_TOL


# ----------------------------------------------------------------------
# the engines against the live JAX engines
# ----------------------------------------------------------------------
def _counters(eng) -> dict:
    return {"spec_rounds": eng.spec_rounds,
            "spec_drafted": eng.spec_drafted,
            "spec_accepted": eng.spec_accepted,
            "spec_emitted": eng.spec_emitted,
            "spec_accept_mean": eng.spec_accept_mean(),
            "acceptance_rate": eng.acceptance_rate,
            "n_host_syncs": eng.n_host_syncs,
            "tokens_generated": eng.tokens_generated,
            "max_macro_tokens": eng.max_macro_tokens,
            "n_preemptions": getattr(eng, "n_preemptions", None)}


def _run_paged(eng, req_cls, n=18):
    """Tight pool (forces preemption) + mid-stream admission: the
    reference's ``run_paged`` recipe."""
    for i, p in enumerate(PROMPTS[:2]):
        eng.submit(req_cls(i, list(p), max_new_tokens=n))
    for _ in range(3):
        eng.step()
    for i, p in enumerate(PROMPTS[2:], start=2):
        eng.submit(req_cls(i, list(p), max_new_tokens=n))
    done = sorted(eng.run(), key=lambda r: r.id)
    assert len(done) == len(PROMPTS)
    return {"streams": [r.out_tokens for r in done],
            "stamps": [(r.t_submit, r.t_admit, r.t_first, r.t_done)
                       for r in done], **_counters(eng)}


def _run_slots(eng, req_cls, n=16):
    for i, p in enumerate(PROMPTS):
        eng.submit(req_cls(i, list(p), max_new_tokens=n))
    done = sorted(eng.run(), key=lambda r: r.id)
    assert len(done) == len(PROMPTS)
    return {"streams": [r.out_tokens for r in done],
            "stamps": [(r.t_submit, r.t_admit, r.t_first, r.t_done)
                       for r in done], **_counters(eng)}


@pytest.fixture(scope="module")
def mha():
    jc, tc = config_pair("mha")
    npp = jax_params(jc, seed=0)
    return jc, tc, npp, bridged(npp, tc)


@pytest.fixture(scope="module")
def plain_streams(mha):
    """The port's non-speculative paged streams on the recipe."""
    _, tc, _, tp = mha
    return _run_paged(TEngine(tc, tp, device="cpu", **PAGED_KW),
                      TRequest)["streams"]


@pytest.mark.parametrize("k", [1, 4, 8])
def test_paged_spec_engine_matches_live_jax_engine(mha, plain_streams, k):
    jc, tc, npp, tp = mha
    want = _run_paged(JEngine(jc, npp, speculative=k, **PAGED_KW), JRequest)
    got = _run_paged(TEngine(tc, tp, speculative=k, device="cpu",
                             **PAGED_KW), TRequest)
    assert got == want
    assert want["n_preemptions"] > 0 and want["spec_rounds"] > 0
    assert got["n_host_syncs"] == got["spec_rounds"]
    assert got["streams"] == plain_streams      # exact: greedy is greedy


def test_slot_spec_engine_matches_live_jax_engine(mha):
    jc, tc, npp, tp = mha
    want = _run_slots(JSlotEngine(jc, npp, speculative=4, **SLOT_KW),
                      JRequest)
    got = _run_slots(TSlotEngine(tc, tp, speculative=4, device="cpu",
                                 **SLOT_KW), TRequest)
    assert got == want and want["spec_rounds"] > 0
    plain = _run_slots(TSlotEngine(tc, tp, device="cpu", **SLOT_KW),
                       TRequest)
    assert got["streams"] == plain["streams"]


def test_int8_spec_engine_matches_live_jax_engine(mha):
    jc, tc, npp, tp = mha
    want = _run_paged(JEngine(jc, npp, speculative=4, quantization="int8",
                              **PAGED_KW), JRequest)
    eng = TEngine(tc, tp, speculative=4, quantization="int8", device="cpu",
                  **PAGED_KW)
    assert eng.quantization == "int8"
    assert _run_paged(eng, TRequest) == want
    assert want["spec_rounds"] > 0


@pytest.fixture(scope="module")
def draft():
    """A smoke smollm draft on its own weights (seed 5), both sides."""
    jc, tc = config_pair("mha")
    npp = jax_params(jc, seed=5)
    return jc, tc, npp, bridged(npp, tc)


def test_model_draft_engine_matches_live_jax_engine(mha, plain_streams,
                                                    draft):
    jc, tc, npp, tp = mha
    djc, dtc, dnp, dtp = draft
    jd = jspec.ModelDraft(djc, params=dnp)
    td = tspec.ModelDraft(dtc, params=dtp, device="cpu")
    want = _run_paged(JEngine(jc, npp, speculative={"k": 4, "provider": jd},
                              **PAGED_KW), JRequest)
    got = _run_paged(TEngine(tc, tp, speculative={"k": 4, "provider": td},
                             device="cpu", **PAGED_KW), TRequest)
    assert got == want
    assert td.n_host_syncs == jd.n_host_syncs == want["spec_drafted"] // 4
    assert got["streams"] == plain_streams


def test_model_draft_proposals_match_reference(draft):
    """Proposals through growth, rollback (a history that leaves what the
    draft fed) and several rows: equal lists and host syncs."""
    djc, dtc, dnp, dtp = draft
    jd = jspec.ModelDraft(djc, params=dnp, cache_len=16)
    td = tspec.ModelDraft(dtc, params=dtp, cache_len=16, device="cpu")
    rng = np.random.default_rng(80)
    hist = {0: rng.integers(1, djc.vocab_size, 7).tolist(),
            2: rng.integers(1, djc.vocab_size, 20).tolist()}
    for step in range(6):
        for row in (0, 2):
            k = 3 if step % 2 else 4
            want = jd.propose(row, hist[row], k)
            got = td.propose(row, hist[row], k)
            assert got == want
            # accept the first two proposals, then a token of our own
            hist[row] = hist[row] + want[:2] + [int(rng.integers(1, 50))]
        if step == 3:
            hist[0] = hist[0][:5]            # a rollback below the fed tail
    assert td.n_host_syncs == jd.n_host_syncs == 12
    assert td.cache_len == jd.cache_len > 16


def test_default_model_draft_is_the_smoke_smollm():
    draft = tspec.SpecConfig.make({"k": 2, "draft": "model"}).provider
    assert isinstance(draft, tspec.ModelDraft) and draft.model is None
    eng = TEngine(config_pair("mha")[1], device="cpu", max_rows=2,
                  max_len=32, speculative=tspec.SpecConfig(
                      k=2, provider=draft))
    assert draft.device == eng.device
    assert draft.propose(0, [1, 2, 3], 2) == draft.propose(0, [1, 2, 3], 2)
    assert draft.cfg.name == "smollm-360m-smoke"
    assert draft.n_host_syncs == 2


# ----------------------------------------------------------------------
# n-gram drafts, SpecConfig.make, arch gating
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_ngram_draft_matches_reference(n):
    rng = np.random.default_rng(90 + n)
    jd, td = jspec.NgramDraft(n=n), tspec.NgramDraft(n=n)
    for _ in range(30):
        hist = rng.integers(0, 6, int(rng.integers(0, 25))).tolist()
        k = int(rng.integers(1, 9))
        assert td.propose(0, hist, k) == jd.propose(0, hist, k)


@pytest.mark.parametrize("spec", [None, False, True, 3, {"k": 2, "ngram": 4},
                                  {"k": 5, "draft": "model", "seed": 7},
                                  "spec_config", "provider"])
def test_spec_config_make_matches_reference(spec):
    def form(mod):
        if spec == "spec_config":
            return mod.SpecConfig(k=6, ngram=2)
        if spec == "provider":
            return mod.NgramDraft(n=2)
        return spec
    want, got = jspec.SpecConfig.make(form(jspec)), \
        tspec.SpecConfig.make(form(tspec))
    if want is None:
        assert got is None
        return
    fields = ("k", "draft", "ngram", "draft_cfg", "seed")
    assert ([getattr(got, f) for f in fields]
            == [getattr(want, f) for f in fields])
    assert type(got.provider).__name__ == type(want.provider).__name__
    assert type(got.provider).__module__ == "repro_torch.serving.speculative"


@pytest.mark.parametrize("spec", [{"k": 0}, {"k": -1}, {"draft": "oracle"},
                                  "ngram", 2.5])
def test_spec_config_make_errors_match_reference(spec):
    with pytest.raises(ValueError) as want:
        jspec.SpecConfig.make(spec)
    with pytest.raises(ValueError) as got:
        tspec.SpecConfig.make(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["mha", "gqa", "mamba", "hybrid"])
def test_spec_supported_matches_reference(name):
    jc, tc = config_pair(name)
    assert tspec.spec_supported(tc) == jspec.spec_supported(jc)
    assert tspec.spec_supported(tc) == (name in ("mha", "gqa"))


@pytest.mark.parametrize("cls", [TEngine, TSlotEngine])
def test_falcon_mamba_gates_speculation_off(cls):
    """The falcon-mamba smoke model refuses speculation as the reference
    does: ``spec_gated_off`` is set and the engine decodes as usual, with
    the stream of an engine never asked to speculate."""
    _, tc = config_pair("mamba")
    kw = (dict(max_rows=2, max_len=32, block_size=8) if cls is TEngine
          else dict(max_batch=2, cache_len=32))
    streams = []
    for spec in (4, None):
        eng = cls(tc, seed=3, speculative=spec, device="cpu", **kw)
        assert eng.spec is None
        assert eng.spec_gated_off == (spec is not None)
        for i, p in enumerate(PROMPTS[:3]):
            eng.submit(TRequest(i, list(p), max_new_tokens=6))
        streams.append({r.id: r.out_tokens for r in eng.run()})
        assert eng.spec_rounds == 0
    assert streams[0] == streams[1] and len(streams[0]) == 3
