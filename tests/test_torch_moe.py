"""The port's mixture of experts against the JAX package's, on the CPU.

``models/moe.py::moe_apply`` against the reference's ``moe_apply`` on the
same numpy inputs (float32, tolerance 1e-5: sums in another order): the
output, ``moe_aux_loss`` and ``moe_drop_frac``, at T = 1, 8, 12 and 128
tokens shaped (B, 1, D) as a decode step and (1, C, D) as a prefill
chunk, with the router as drawn (no drops) and biased towards one expert
(every token claims it: drops once T passes its capacity).  Then the
mixtral-8x7b and kimi-k2-1t-a32b smoke models (2 layers, 4 experts,
top-2; mixtral's two ``swa`` layers on a ring of 32 slots) on the JAX
model's weights, bridged into the port: both engines, paged int8, the
pipelined engines at 2 stages, and the capacity-coupled macro-step of
tests/test_paged.py (12 rows with staggered budgets, K 8 against K 1),
whose streams, ``t_*`` stamps and counters must equal the live JAX
engines', with rows reused and mixtral's ring wrapping.  The parameter
counters equal the reference's for both full configs.

The ``cuda``-marked test runs ``moe_apply`` on the card against its CPU
result (float32, 1e-5) under ``torch.cuda.set_sync_debug_mode("error")``:
routing, dispatch and combine never make the host wait.  It skips
without a card; the JAX side is imported inside a fixture, so the card's
machine (no JAX) collects this file.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import pipeline as tpipe  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
TOL = 1e-5
ARCHS = ("mixtral-8x7b", "kimi-k2-1t-a32b")
#: (B, T) of the moe_apply cases: a decode step's B rows of one token,
#: or one row's chunk of T tokens
SHAPES = [(1, 1), (8, 1), (1, 8), (12, 1), (1, 128)]
#: published totals, tests/test_configs.py
PUBLISHED_B = {"mixtral-8x7b": (46.7, 0.06), "kimi-k2-1t-a32b": (1042.0, 0.08)}


@pytest.fixture(scope="module")
def J():
    """The JAX side (skipped where JAX is absent, as on the card's
    machine, which runs only the ``cuda`` test of this file)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from _torch_ref import jax_params
    from repro.configs import get_config as jget_config
    from repro.configs import get_smoke_config as jget_smoke
    from repro.core import network as jnet
    from repro.microservice import partition as jpart
    from repro.models import moe as jmoe
    from repro.serving import engine as jengine
    from repro.serving import pipeline as jpipe
    return SimpleNamespace(jax=jax, jnp=jnp, jax_params=jax_params,
                           get_config=jget_config, get_smoke=jget_smoke,
                           net=jnet, partition=jpart, moe=jmoe,
                           engine=jengine, pipe=jpipe)


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _moe_inputs(cfg, b, t, biased, seed):
    """Router and experts at their fan-in scale (outputs of unit size)
    and x (B, T, D); ``biased``: x has mean 1 and the router's column 0
    a constant 0.5 more, so expert 0 tops every token's choice."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.moe_d_ff_eff, cfg.n_experts
    p = {"router": rng.standard_normal((d, e), np.float32) * d ** -0.5,
         "we_gate": rng.standard_normal((e, d, f), np.float32) * d ** -0.5,
         "we_up": rng.standard_normal((e, d, f), np.float32) * d ** -0.5,
         "we_down": rng.standard_normal((e, f, d), np.float32) * f ** -0.5}
    x = rng.standard_normal((b, t, d), np.float32)
    if biased:
        x += 1.0
        p["router"][:, 0] += 0.5
    return p, x


@pytest.mark.parametrize("biased", [False, True], ids=["as-drawn", "biased"])
@pytest.mark.parametrize("b,t", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(J, arch, b, t, biased):
    jc, tc = J.get_smoke(arch), get_smoke_config(arch)
    p, x = _moe_inputs(tc, b, t, biased, seed=b * 1000 + t + 7 * biased)
    jy, jaux = J.moe.moe_apply({k: J.jnp.asarray(v) for k, v in p.items()},
                               J.jnp.asarray(x), jc)
    ty, taux = tmoe.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), tc)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    assert _err(ty, jy) < TOL
    assert abs(float(taux["moe_aux_loss"]) - float(jaux["moe_aux_loss"])) < TOL
    drop = float(taux["moe_drop_frac"])
    assert drop == float(jaux["moe_drop_frac"])
    n = b * t
    assert tmoe._capacity(n, tc) == J.moe._capacity(n, jc)
    # an expert takes at most one claim a token, so nothing drops while
    # the tokens fit its places; biased, every token claims expert 0, so
    # at least the tokens past its places drop
    cap = tmoe._capacity(n, tc)
    if biased and n > cap:
        assert drop >= (n - cap) / (n * tc.experts_per_token) > 0
    else:
        assert drop == 0.0


def test_configs_and_counters_match_the_reference(J):
    """Both MoE configs equal the reference's, full and smoke; the
    counters equal its ``num_params`` / ``num_active_params`` (the
    published 46.7B and 1042B) and ``decompose`` sizes the same stages;
    serving and training accept MoE (one train forward runs, its MoE
    terms live)."""
    for arch in ARCHS:
        full, jfull = get_config(arch), J.get_config(arch)
        assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(J.get_smoke(arch))
        assert full.moe_d_ff_eff == jfull.moe_d_ff_eff
        assert full.num_params() == jfull.num_params()
        assert full.num_active_params() == jfull.num_active_params()
        exp, tol = PUBLISHED_B[arch]
        assert abs(full.num_params() / 1e9 - exp) / exp <= tol
        kind = full.block_pattern[0]
        assert full.layer_params(kind) == jfull.layer_params(kind)
        assert (full.layer_active_params(kind)
                == jfull.layer_active_params(kind))
        from repro_torch.microservice import partition as tpart
        assert [dataclasses.astuple(s) for s in tpart.decompose(full, 2)] == \
            [dataclasses.astuple(s) for s in J.partition.decompose(jfull, 2)]
        ttfm.check_supported(full)
        ttfm.check_supported(full, "decode")
        ttfm.check_supported(full, "train")
        model = Model(get_smoke_config(arch), device="cpu")
        logits, _, aux = model.forward(
            model.init(torch.Generator().manual_seed(0)),
            {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
        assert bool(torch.isfinite(logits).all())
        assert float(aux["moe_aux_loss"]) > 0


_MODELS = {}


def _model(J, arch):
    """(arch, JAX config, port config, the JAX model's numpy params,
    them bridged into the port), once per arch."""
    if arch not in _MODELS:
        jc, tc = J.get_smoke(arch), get_smoke_config(arch)
        npp = J.jax_params(jc, seed=5)
        _MODELS[arch] = (arch, jc, tc, npp,
                         params_from_numpy(npp, tc, "cpu", torch.float32))
    return _MODELS[arch]


@pytest.fixture(params=ARCHS)
def model(request, J):
    return _model(J, request.param)


def test_bridge_and_init_carry_the_moe_leaves(model):
    """The bridge copies ``moe.{router, we_*}`` into the port (the router
    float32 in a bf16 model too) and back; ``Model.init`` draws the same
    leaves; int8 packing leaves router and experts dense."""
    arch, jc, tc, npp, tp = model
    seg, jseg = tp["blocks"]["segments"][0], npp["blocks"]["segments"][0]
    assert sorted(seg["moe"]) == sorted(jseg["moe"]) == [
        "router", "we_down", "we_gate", "we_up"]
    for k, v in jseg["moe"].items():
        assert torch.equal(seg["moe"][k], torch.from_numpy(np.array(v)))
    bf = params_from_numpy(npp, tc, "cpu", torch.bfloat16)
    moe = bf["blocks"]["segments"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["we_gate"].dtype == torch.bfloat16
    back = params_to_numpy(tp, tc)["blocks"]["segments"][0]["moe"]
    for k, v in jseg["moe"].items():
        np.testing.assert_array_equal(back[k], v)
    drawn = Model(dataclasses.replace(tc, dtype="bfloat16"),
                  device="cpu").init(torch.Generator().manual_seed(0))
    dseg = drawn["blocks"]["segments"][0]
    assert {k: (tuple(v.shape), v.dtype) for k, v in dseg["moe"].items()} \
        == {k: (tuple(v.shape), moe[k].dtype) for k, v in seg["moe"].items()}
    assert "mlp" not in dseg
    packed = quantize_params(tp, "int8")["blocks"]["segments"][0]
    assert all(isinstance(v, torch.Tensor) for v in packed["moe"].values())
    assert isinstance(packed["attn"]["wq"], dict)


def _trace(vocab):
    """Five prompts of 17-89 tokens: prefills of whole chunks of 16 and
    one of 8 more (the JAX engine compiles a program for each chunk
    length)."""
    rng = np.random.default_rng(29)
    return [rng.integers(1, vocab, int(n)).tolist()
            for n in (17, 49, 65, 89, 33)]


def _drive(eng, req_cls, prompts, n=16):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(i, list(p), max_new_tokens=n))
    done = sorted(eng.run(), key=lambda r: r.id)
    out = {"streams": [r.out_tokens for r in done],
           "stamps": [(r.t_submit, r.t_admit, r.t_first, r.t_done)
                      for r in done],
           "n_host_syncs": eng.n_host_syncs,
           "prefill_tokens": eng.prefill_tokens,
           "tokens_generated": eng.tokens_generated,
           "max_macro_tokens": eng.max_macro_tokens,
           "spec_gated_off": eng.spec_gated_off}
    if hasattr(eng, "pc"):
        eng.pc.check()
        out.update(n_preemptions=eng.n_preemptions,
                   used_blocks=eng.pc.used_blocks)
    return out


def _engines(J, engine, pipelined):
    if pipelined:
        return ((J.pipe.PagedPipelinedEngine, tpipe.PagedPipelinedEngine)
                if engine == "paged" else
                (J.pipe.PipelinedEngine, tpipe.PipelinedEngine))
    return ((J.engine.PagedServingEngine, tengine.PagedServingEngine)
            if engine == "paged" else
            (J.engine.ServingEngine, tengine.ServingEngine))


#: (arch, engine, extra kwargs, pipelined): both engines for both
#: models, int8 weights and the paged pipeline on mixtral's ring, the
#: slot pipeline on kimi
RUNS = [("mixtral-8x7b", "paged", {"speculative": 4}, False),
        ("mixtral-8x7b", "slot", {}, False),
        ("mixtral-8x7b", "paged", {"quantization": "int8"}, False),
        ("mixtral-8x7b", "paged", {}, True),
        ("kimi-k2-1t-a32b", "paged", {"speculative": 4}, False),
        ("kimi-k2-1t-a32b", "slot", {}, False),
        ("kimi-k2-1t-a32b", "slot", {}, True)]


def _run_id(run):
    arch, engine, extra, pipelined = run
    tags = [arch.split("-")[0], "pipe" if pipelined else "", engine]
    tags += [f"{k[:5]}{v}" for k, v in extra.items()]
    return "-".join(t for t in tags if t)


@pytest.mark.parametrize("arch,engine,extra,pipelined", RUNS,
                         ids=[_run_id(r) for r in RUNS])
def test_engines_match_live_jax_engines(J, arch, engine, extra, pipelined):
    """Five requests (prompts of 17-89 tokens, 16 new tokens each)
    through three rows, so rows are reused; mixtral's ring (w 32) wraps.
    K = 4, chunks of 16.  ``speculative=4`` gates off (MoE) on both
    sides; the pipelined engines run 2 stages placed round-robin over a
    seeded network.  Streams, stamps and counters equal the JAX
    engine's."""
    _, jc, tc, npp, tp = _model(J, arch)
    prompts = _trace(jc.vocab_size)
    kw = dict(prefill_chunk=16, decode_steps=4, **extra)
    kw.update(dict(max_rows=3, max_len=128, block_size=16)
              if engine == "paged" else dict(max_batch=3, cache_len=128))
    jcls, tcls = _engines(J, engine, pipelined)
    if pipelined:
        jn = J.net.make_network(np.random.default_rng(3))
        from repro_torch.core import network as tnet
        tn = tnet.make_network(np.random.default_rng(3))
        jeng = jcls(jc, npp, n_stages=2, net=jn, **kw)
        teng = tcls(tc, tp, n_stages=2, net=tn, device="cpu", **kw)
        jplace = J.pipe.place_stages(
            jeng.to_application(np.random.default_rng(1)), jn, "round_robin")
        tplace = tpipe.place_stages(
            teng.to_application(np.random.default_rng(1)), tn, "round_robin")
        assert tplace == jplace and len(set(tplace.values())) > 1
        jeng.set_placement(jplace)
        teng.set_placement(tplace)
    else:
        jeng = jcls(jc, npp, **kw)
        teng = tcls(tc, tp, device="cpu", **kw)
    want = _drive(jeng, J.engine.Request, prompts)
    got = _drive(teng, tengine.Request, prompts)
    assert got == want
    assert all(len(s) == 16 for s in got["streams"])
    if pipelined:
        assert abs(teng.transfer_mb - jeng.transfer_mb) <= 1e-12
        assert teng.transfer_mb > 0
    if extra.get("speculative"):
        assert got["spec_gated_off"] and teng.spec_rounds == 0
    if arch == "mixtral-8x7b":
        assert any(len(p) + 16 > jc.window for p in prompts)


def test_capacity_coupled_macro_step(J, model, monkeypatch):
    """tests/test_paged.py's capacity-coupled trace: 12 rows of 3-token
    prompts, staggered budgets, so rows go masked mid-scan and keep
    feeding the router token 0 at a frozen pos.  Capacity ranks claims
    over the whole co-batch, so the masked rows' claims are visible to
    the live ones: K 8 must equal K 1 in the port, and the port the JAX
    engine, streams, stamps and counters; claims are dropped."""
    arch, jc, tc, npp, tp = model
    drops = []
    apply = tmoe.moe_apply

    def recorded(params, x, cfg):
        y, aux = apply(params, x, cfg)
        drops.append(float(aux["moe_drop_frac"]))
        return y, aux
    monkeypatch.setattr(tmoe, "moe_apply", recorded)

    def run(cls, params, k, req_cls, **dev):
        eng = cls(jc if cls is J.engine.ServingEngine else tc, params,
                  max_batch=12, cache_len=32, prefill_chunk=4,
                  decode_steps=k, **dev)
        for i in range(12):
            eng.submit(req_cls(i, [3 + i, 1, 4],
                               max_new_tokens=3 + (i % 5)))
        done = sorted(eng.run(), key=lambda r: r.id)
        return {"streams": [r.out_tokens for r in done],
                "stamps": [(r.t_submit, r.t_admit, r.t_first, r.t_done)
                           for r in done],
                "n_host_syncs": eng.n_host_syncs,
                "tokens_generated": eng.tokens_generated}
    k8 = run(tengine.ServingEngine, tp, 8, tengine.Request, device="cpu")
    assert max(drops) > 0
    k1 = run(tengine.ServingEngine, tp, 1, tengine.Request, device="cpu")
    assert k8["streams"] == k1["streams"]
    want = run(J.engine.ServingEngine, npp, 8, J.engine.Request)
    assert k8 == want


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(8, 1), (1, 128)])
def test_cuda_moe_apply_makes_no_host_sync(b, t):
    """``moe_apply`` on the card equals its CPU result (float32, 1e-5)
    at a decode step's and a chunk's shape, with drops (a biased
    router) and without, and runs under
    ``set_sync_debug_mode("error")``: no operation of it waits on the
    host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda is not available")
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), d_model=256,
                              moe_d_ff=512, dtype="float32")
    for biased in (False, True):
        p, x = _moe_inputs(cfg, b, t, biased, seed=b + t)
        pc = {k: torch.from_numpy(v) for k, v in p.items()}
        want, want_aux = tmoe.moe_apply(pc, torch.from_numpy(x), cfg)
        pg = {k: v.to(dev) for k, v in pc.items()}
        xg = torch.from_numpy(x).to(dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, aux = tmoe.moe_apply(pg, xg, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert _err(got.cpu(), want) < TOL
        assert float(aux["moe_drop_frac"]) == float(want_aux["moe_drop_frac"])
        assert abs(float(aux["moe_aux_loss"])
                   - float(want_aux["moe_aux_loss"])) < TOL
