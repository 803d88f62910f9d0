"""The port's sliding-window ring against the JAX package's, on the CPU.

The gemma3-12b smoke model (2 layers, ``("swa", "attn")``, window 32,
hd 32), GQA variants of it (6 query heads over 2 KV heads; window 32,
and 40, which is no whole number of blocks) and one at mixtral-8x7b's
head shape (8 query heads over 2 of 128) run in both packages on the
JAX model's weights, carried into the port by ``repro_torch.bridge``: the ring branches of the four attention paths
(paged and dense chunk, paged and dense decode), the ledger's ring
block group, and both engines with the ring wrapping (window 32,
``max_len`` 128, prompts of 20-90 tokens, rows reused), whose streams,
``t_*`` stamps and counters must equal the live JAX engines'.  Chunks
and decode steps are placed at pos 0 (only chunk keys valid), pos < w,
pos = w - 1 and pos >> w, with chunks shorter and longer than the ring.
Everything runs in float32, where the ring kernel's wrapper takes its
plain version.  Tolerance: 1e-5 for attention outputs and pools, as in
test_torch_model.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_ref import bridged, jax_params, t  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.serving.engine import PagedServingEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JSlotEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    ring_chunk_attention, ring_chunk_attention_plain)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving.engine import PagedServingEngine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TSlotEngine  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
ATTN_TOL = 1e-5
BS, MAX_LEN = 16, 128
#: the smoke reduction gives 4 query heads over 4 KV heads; the GQA
#: variant keeps G = 3 query heads per KV head; "gqa-w40" gives it a
#: ring of 40 slots, which ends inside its third block of 16, so the
#: slots past w in the last ring block exist and must never be read;
#: "mixtral-heads" takes mixtral-8x7b's head shape (hd 128, G 4) at the
#: smoke width and window (mixtral's own smoke reduction has gemma3's
#: attention: 4 heads over 4 of 32, window 32)
GQA = dict(n_heads=6, n_kv_heads=2, head_dim=32)
VARIANTS = {"mha": {}, "gqa": GQA, "gqa-w40": dict(GQA, window=40),
            "mixtral-heads": dict(n_heads=8, n_kv_heads=2, head_dim=128)}
#: (pos, C): pos 0 (no ring key valid), pos < w, pos = w - 1 (w = 32),
#: pos >> w; chunks shorter and longer than the ring
CHUNKS = [(0, 16), (20, 8), (31, 16), (200, 16), (0, 64), (45, 64),
          (200, 48)]


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _pair(name):
    over = VARIANTS[name]
    return (dataclasses.replace(jget_smoke("gemma3-12b"), **over),
            dataclasses.replace(get_smoke_config("gemma3-12b"), **over))


@pytest.fixture(scope="module", params=list(VARIANTS))
def setup(request):
    jc, tc = _pair(request.param)
    npp = jax_params(jc, seed=3)
    return jc, tc, npp, bridged(npp, tc)


def _swa_params(npp, tp):
    """The swa layer's attention params on both sides (the reference
    stores a one-layer segment unstacked; the bridge stacks it)."""
    jp = {k: jnp.asarray(v) for k, v in
          npp["blocks"]["segments"][0]["attn"].items()}
    tparams = {k: v[0] for k, v in tp["blocks"]["segments"][0]["attn"].items()}
    return jp, tparams


def _ring_pools(rng, cfg, n_phys):
    shape = (n_phys, BS, cfg.n_kv_heads, cfg.head_dim)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


def test_configs_match_the_reference():
    full = get_config("gemma3-12b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jget_config("gemma3-12b"))
    smoke = get_smoke_config("gemma3-12b")
    assert dataclasses.asdict(smoke) == dataclasses.asdict(
        jget_smoke("gemma3-12b"))
    assert (full.n_layers, full.block_pattern.count("swa"), full.window,
            full.head_dim, full.n_heads, full.n_kv_heads) == (
                48, 40, 1024, 256, 16, 8)
    assert (smoke.block_pattern, smoke.window, smoke.head_dim) == (
        ("swa", "attn"), 32, 32)
    ttfm.check_supported(full)


@pytest.mark.parametrize("pos,c", CHUNKS)
def test_paged_ring_chunk_matches_reference(setup, pos, c):
    """The swa branch of ``paged_chunk_self_attention``: attention over
    ``[old ring ; chunk]`` through the row's ring table, then the ring
    write of the chunk's last min(C, w) keys, in place."""
    jc, tc, npp, tp = setup
    rng = np.random.default_rng(40 + pos + c)
    nb_swa = -(-jc.window // BS)
    kp, vp = _ring_pools(rng, jc, nb_swa + 3)
    swa_table = (rng.permutation(nb_swa + 2)[:nb_swa] + 1).astype(
        np.int32)[None]
    tables = np.zeros((1, MAX_LEN // BS), np.int32)
    x = rng.standard_normal((1, c, jc.d_model), dtype=np.float32)
    jp, tparams = _swa_params(npp, tp)
    jout, jc_kv = jattn.paged_chunk_self_attention(
        jp, jnp.asarray(x), {"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
        {"tables": jnp.asarray(tables), "swa_tables": jnp.asarray(swa_table)},
        jnp.asarray([pos], jnp.int32), jc, "swa")
    cache = {"k": t(kp.copy()), "v": t(vp.copy())}
    tout, _ = tattn.paged_chunk_self_attention(
        tparams, t(x), cache, {"tables": t(tables), "swa_tables": t(swa_table)},
        pos, tc, "swa")
    assert _err(tout, jout) < ATTN_TOL
    assert _err(cache["k"], jc_kv["k"]) < ATTN_TOL
    assert _err(cache["v"], jc_kv["v"]) < ATTN_TOL


@pytest.mark.parametrize("pos,c", CHUNKS)
def test_dense_ring_chunk_matches_reference(setup, pos, c):
    """The swa branch of ``chunk_self_attention`` on one slot's ring row
    of W slots (the ring kernel on it as one block of W slots)."""
    jc, tc, npp, tp = setup
    rng = np.random.default_rng(60 + pos + c)
    w = min(jc.window, MAX_LEN)
    shape = (1, w, jc.n_kv_heads, jc.head_dim)
    kc = rng.standard_normal(shape, dtype=np.float32)
    vc = rng.standard_normal(shape, dtype=np.float32)
    x = rng.standard_normal((1, c, jc.d_model), dtype=np.float32)
    jp, tparams = _swa_params(npp, tp)
    jout, jc_kv = jattn.chunk_self_attention(
        jp, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        jnp.asarray([pos], jnp.int32), jc, "swa")
    cache = {"k": t(kc.copy()), "v": t(vc.copy())}
    tout, _ = tattn.chunk_self_attention(tparams, t(x), cache, pos, tc,
                                         "swa")
    assert _err(tout, jout) < ATTN_TOL
    assert _err(cache["k"], jc_kv["k"]) < ATTN_TOL
    assert _err(cache["v"], jc_kv["v"]) < ATTN_TOL


@pytest.mark.parametrize("pos,c", [(0, 16), (31, 16), (200, 48), (45, 64)])
def test_ring_plain_dense_view_equals_paged(pos, c):
    """The plain version on a paged ring (blocks of 16, shuffled table)
    and on the same keys as one block of w slots gives the same bits,
    as the kernel must; and the wrapper takes the plain version for CPU
    tensors."""
    rng = np.random.default_rng(80 + pos)
    w, kv, h, hd, nb = 32, 2, 6, 32, 2
    ring = rng.standard_normal((2, w, kv, hd), dtype=np.float32)
    table = (rng.permutation(nb + 1)[:nb] + 1).astype(np.int32)
    pools = np.zeros((2, nb + 2, BS, kv, hd), np.float32)
    pools[:, table] = ring.reshape(2, nb, BS, kv, hd)
    q = t(rng.standard_normal((c, h, hd), dtype=np.float32))
    kn = t(rng.standard_normal((c, kv, hd), dtype=np.float32))
    vn = t(rng.standard_normal((c, kv, hd), dtype=np.float32))
    paged = ring_chunk_attention_plain(q, t(pools[0]), t(pools[1]), t(table),
                                       kn, vn, pos, w)
    dense = ring_chunk_attention(q, t(ring[0][None]), t(ring[1][None]),
                                 torch.zeros(1, dtype=torch.int32), kn, vn,
                                 pos, w)
    assert torch.isfinite(paged).all()
    assert torch.equal(paged, dense)


@pytest.mark.parametrize("dense", [False, True])
def test_ring_decode_matches_reference(setup, dense):
    """One decode token against the ring, paged (``swa_tables``) and
    dense: the write at ``pos % w``, then the decode kernels' plain
    versions at the clamped pos, for rows before the wrap, at w - 1, just
    past it and far past it, and a masked row on the scratch block."""
    jc, tc, npp, tp = setup
    rng = np.random.default_rng(90 + dense)
    w = jc.window
    pos = np.array([0, 5, w - 1, w, w + 3, 200], np.int32)
    b = len(pos)
    x = rng.standard_normal((b, 1, jc.d_model), dtype=np.float32)
    jp, tparams = _swa_params(npp, tp)
    if dense:
        shape = (b, w, jc.n_kv_heads, jc.head_dim)
        kc = rng.standard_normal(shape, dtype=np.float32)
        vc = rng.standard_normal(shape, dtype=np.float32)
        jout, jc_kv = jattn.decode_self_attention(
            jp, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
            jnp.asarray(pos), jc, "swa")
        cache = {"k": t(kc.copy()), "v": t(vc.copy())}
        tout, _ = tattn.decode_self_attention(tparams, t(x), cache, t(pos),
                                              tc, "swa")
    else:
        nb_swa = -(-w // BS)
        kp, vp = _ring_pools(rng, jc, b * nb_swa + 1)
        swa_tables = (rng.permutation(b * nb_swa).reshape(b, nb_swa) + 1
                      ).astype(np.int32)
        swa_tables[-1] = 0                          # a masked row
        tables = np.zeros((b, MAX_LEN // BS), np.int32)
        jout, jc_kv = jattn.paged_decode_self_attention(
            jp, jnp.asarray(x), {"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
            {"tables": jnp.asarray(tables),
             "swa_tables": jnp.asarray(swa_tables)},
            jnp.asarray(pos), jc, "swa")
        cache = {"k": t(kp.copy()), "v": t(vp.copy())}
        tout, _ = tattn.paged_decode_self_attention(
            tparams, t(x), cache,
            {"tables": t(tables), "swa_tables": t(swa_tables)}, t(pos), tc,
            "swa")
    assert _err(tout[:-1], jout[:-1]) < ATTN_TOL
    if dense:       # the paged masked row reads the scratch block
        assert _err(tout, jout) < ATTN_TOL
    assert _err(cache["k"], jc_kv["k"]) < ATTN_TOL
    assert _err(cache["v"], jc_kv["v"]) < ATTN_TOL


def _ledger_state(pc):
    """What the public API shows: both groups' tables (whose ids follow
    the LIFO free lists' order) and the attn pool's counts."""
    return {"tables": pc.tables.tolist(), "swa_tables": pc.swa_tables.tolist(),
            "free_blocks": pc.free_blocks, "used_blocks": pc.used_blocks}


def test_ledger_ring_group_matches_reference():
    """admit / ensure / release sequences on both ledgers: the attn and
    swa tables (the free lists' order shows in the block ids each
    admission takes), ``can_admit`` (which needs nb_swa free ring
    blocks), ``check()``, ``meta()``, the pools ``struct()`` builds and
    ``cache_bytes``, against the reference's."""
    jc, tc = _pair("mha")
    kw = dict(max_rows=3, max_len=MAX_LEN, block_size=BS, num_blocks=12,
              share_prefixes=True)
    jpc = jkv.PagedCache(jc, **kw)
    tpc = tkv.PagedCache(tc, device="cpu", **kw)
    assert (tpc.has_swa, tpc.window_eff, tpc.nb_swa,
            tpc.sharing_supported, tpc.share_prefixes) == (
                jpc.has_swa, jpc.window_eff, jpc.nb_swa,
                jpc.sharing_supported, jpc.share_prefixes) == (
                    True, 32, 2, False, False)
    ops = [("admit", 0, 20), ("admit", 1, 45), ("ensure", 0, 32),
           ("admit", 2, 30), ("can", 5), ("release", 1), ("can", 60),
           ("admit", 1, 70), ("ensure", 2, 32), ("release", 0),
           ("release", 2), ("admit", 0, 90), ("release", 1), ("release", 0)]
    for op in ops:
        got = want = None
        if op[0] == "admit":
            got, want = tpc.admit(op[1], op[2]), jpc.admit(op[1], op[2])
        elif op[0] == "ensure":
            got, want = tpc.ensure(op[1], op[2]), jpc.ensure(op[1], op[2])
        elif op[0] == "can":
            got, want = tpc.can_admit(op[1]), jpc.can_admit(op[1])
        else:
            tpc.release(op[1])
            jpc.release(op[1])
        assert got == want, op
        assert _ledger_state(tpc) == _ledger_state(jpc), op
        tpc.check()
        jpc.check()
        if op[0] == "admit":
            meta = tpc.meta(row=op[1])
            assert sorted(meta) == ["swa_tables", "tables"]
            assert meta["swa_tables"].tolist() == [jpc.swa_tables[op[1]].tolist()]
    # every row's ring held: a fourth admission would need 2 more ring
    # blocks than the group has
    for row in range(3):
        assert tpc.admit(row, 10) == jpc.admit(row, 10) is True
    assert tpc.can_admit(1) == jpc.can_admit(1) is False
    pools = tpc.struct(torch.float32)
    want = jpc.struct(jnp.float32)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in pools] == [
        {k: v.shape for k, v in c.items()} for c in want]
    assert pools[0]["k"].shape[1] == 3 * 2 + 1        # max_rows * nb_swa + 1
    assert tkv.cache_bytes(tc, 3, MAX_LEN) == jkv.cache_bytes(jc, 3, MAX_LEN)
    dense = tkv.cache_struct(tc, 3, MAX_LEN, torch.float32, device="cpu")
    want = jkv.cache_struct(jc, 3, MAX_LEN, jnp.float32)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in dense] == [
        {k: v.shape for k, v in c.items()} for c in want]


def _trace(vocab):
    rng = np.random.default_rng(23)
    return [rng.integers(1, vocab, int(n)).tolist()
            for n in (20, 45, 70, 90, 33, 61)]


def _drive(eng, req_cls, prompts):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(i, list(p), max_new_tokens=24))
    done = sorted(eng.run(), key=lambda r: r.id)
    out = {"streams": [r.out_tokens for r in done],
           "stamps": [(r.t_submit, r.t_admit, r.t_first, r.t_done)
                      for r in done],
           "n_host_syncs": eng.n_host_syncs,
           "prefill_tokens": eng.prefill_tokens,
           "tokens_generated": eng.tokens_generated,
           "max_macro_tokens": eng.max_macro_tokens,
           "spec_gated_off": eng.spec_gated_off,
           "spec_rounds": eng.spec_rounds}
    if hasattr(eng, "pc"):
        eng.pc.check()
        out.update(n_preemptions=eng.n_preemptions,
                   used_blocks=eng.pc.used_blocks,
                   swa_tables=eng.pc.swa_tables.tolist())
    return out


@pytest.fixture(scope="module")
def gemma():
    jc, tc = _pair("mha")
    npp = jax_params(jc, seed=4)
    return jc, tc, npp, bridged(npp, tc)


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("engine", ["paged", "slot"])
def test_engines_match_live_jax_engines(gemma, engine, chunk):
    """Six requests (prompts of 20-90 tokens, 24 new tokens each) through
    three rows, so rows are reused, with the ring wrapping (w 32 against
    up to 113 positions) and chunks of 16 and of 64 (longer than the
    ring); K = 4.  Streams, stamps and counters equal the JAX engine's."""
    jc, tc, npp, tp = gemma
    prompts = _trace(jc.vocab_size)
    if engine == "paged":
        kw = dict(max_rows=3, max_len=MAX_LEN, block_size=BS,
                  prefill_chunk=chunk, decode_steps=4)
        want = _drive(JEngine(jc, npp, **kw), JRequest, prompts)
        got = _drive(TEngine(tc, tp, device="cpu", **kw), TRequest, prompts)
        # every ring returned (check() found no leak in either group)
        assert want["used_blocks"] == 0 and not np.any(want["swa_tables"])
    else:
        kw = dict(max_batch=3, cache_len=MAX_LEN, prefill_chunk=chunk,
                  decode_steps=4)
        want = _drive(JSlotEngine(jc, npp, **kw), JRequest, prompts)
        got = _drive(TSlotEngine(tc, tp, device="cpu", **kw), TRequest,
                     prompts)
    assert got == want
    assert all(len(s) == 24 for s in got["streams"])


def test_speculation_gates_off_on_the_ring(gemma):
    """``speculative=4`` on a windowed swa model: gated off on both
    sides, and the port's streams equal its plain decode's."""
    jc, tc, npp, tp = gemma
    prompts = _trace(jc.vocab_size)[:4]
    kw = dict(max_rows=4, max_len=MAX_LEN, block_size=BS, prefill_chunk=16,
              decode_steps=4)
    want = _drive(JEngine(jc, npp, speculative=4, **kw), JRequest, prompts)
    got = _drive(TEngine(tc, tp, speculative=4, device="cpu", **kw),
                 TRequest, prompts)
    plain = _drive(TEngine(tc, tp, device="cpu", **kw), TRequest, prompts)
    assert got == want
    assert got["spec_gated_off"] and got["spec_rounds"] == 0
    assert got["streams"] == plain["streams"]
