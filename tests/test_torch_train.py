"""The port's training path against the live JAX package, on the CPU.

Inputs come from numpy seeds; the model weights are the JAX model's,
carried into the port through numpy (``tests/_torch_ref.py``).  Every
comparison runs in float32 on the CPU, where the port's kernel wrappers
take their plain versions.  Tolerances:

* the plain flash version against the Pallas kernel in interpret mode
  and ``ref.flash_attention_ref``: 1e-5 (f32 sums in another order);
  its row log-sum-exp against numpy in float64: 1e-5;
* gradients of the flash and norm Functions against autograd through
  the plain versions and ``jax.grad`` of the reference: 1e-5 of
  max(1, |g|);
* train-mode logits: 1e-4 (test_torch_model.py's bound for a few layers
  of f32 matmuls summed in another order); the loss 1e-5 relative and
  every gradient leaf 1e-5 of max(1, |g|);
* three train steps against the jitted JAX step: ce, gradient norm and
  learning rate within 5e-5 relative at each step.  After the first
  step the two packages' parameters differ by the rounding of AdamW's
  first moves (about lr * sign(g), so a gradient near zero that rounds
  the other way moves its weight by 2 lr), which moves the metrics by a
  few 1e-6 relative;
* ``adamw_update`` on identical inputs: 1e-6; ``cosine_lr``: 1e-7
  relative; ``SyntheticLM`` batches and checkpoint round trips: equal.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_ref import bridged, config_pair, jax_params  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.training.optimizer import adamw_init as jadamw_init  # noqa: E402
from repro.training.optimizer import adamw_update as jadamw_update  # noqa: E402
from repro.training.optimizer import cosine_lr as jcosine_lr  # noqa: E402
from repro.training.train_step import loss_fn as jloss_fn  # noqa: E402
from repro.training.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttentionFn, flash_attention, flash_attention_plain)
from repro_torch.kernels.rmsnorm import (AddRmsNormFn, RmsNormFn,  # noqa: E402
                                         add_rmsnorm_plain, rmsnorm_plain)
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training.data import SyntheticLM  # noqa: E402
from repro_torch.training.optimizer import (AdamWState, adamw_init,  # noqa: E402
                                            adamw_update, cosine_lr)
from repro_torch.training.train_step import (make_train_step,  # noqa: E402
                                             value_and_grad)
from repro_torch.training.tree import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FLASH_TOL, GRAD_TOL, LOGIT_TOL = 1e-5, 1e-5, 1e-4
STEP_RTOL = 5e-5


def t(a):
    return torch.from_numpy(np.array(a))


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _rel(a, b) -> float:
    """Largest difference relative to max(1, |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))


# ----------------------------------------------------------------------
# the contiguous flash form: plain version, log-sum-exp, gradient
# ----------------------------------------------------------------------
# (B, H, KV, S, D, causal, window): causal; non-causal with a window it
# must ignore; a window shorter than S; GQA G 3; S not a multiple of 128
FLASH_CASES = [(2, 4, 4, 64, 32, True, 0), (2, 4, 2, 72, 32, False, 16),
               (1, 4, 2, 96, 32, True, 24), (2, 6, 2, 80, 16, True, 0),
               (1, 3, 1, 200, 64, True, 0), (1, 3, 1, 200, 64, True, 40)]


def _flash_inputs(seed, b, h, kv, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d), dtype=np.float32),
            rng.standard_normal((b, kv, s, d), dtype=np.float32),
            rng.standard_normal((b, kv, s, d), dtype=np.float32))


@pytest.mark.parametrize("b,h,kv,s,d,causal,window", FLASH_CASES)
def test_flash_plain_matches_pallas_and_ref(b, h, kv, s, d, causal, window):
    q, k, v = _flash_inputs(0, b, h, kv, s, d)
    got, _ = flash_attention_plain(t(q), t(k), t(v), causal=causal,
                                   window=window)
    # in interpret mode the Pallas kernel reads past S as garbage, so its
    # blocks divide S (100 at S = 200, not a multiple of 128)
    blk = next(n for n in (128, 100, 64, 40, 32, 24, 16) if s % n == 0)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, block_q=blk, block_k=blk,
                                    interpret=True)
    oracle = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window)
    assert got.shape == (b, h, s, d) and got.dtype == torch.float32
    assert _err(got, pallas) <= FLASH_TOL
    assert _err(got, oracle) <= FLASH_TOL


@pytest.mark.parametrize("q_block", [flash_mod.FLASH_Q_BLOCK, 16])
@pytest.mark.parametrize("b,h,kv,s,d,causal,window", FLASH_CASES)
def test_flash_plain_lse_matches_numpy(monkeypatch, q_block, b, h, kv, s, d,
                                       causal, window):
    """The row log-sum-exp (and the output, in blocks of 16 queries as
    in one block) against numpy in float64."""
    monkeypatch.setattr(flash_mod, "FLASH_Q_BLOCK", q_block)
    q, k, v = _flash_inputs(1, b, h, kv, s, d)
    out, lse = flash_attention_plain(t(q), t(k), t(v), causal=causal,
                                     window=window)
    g = h // kv
    sc = np.einsum("bngqd,bnkd->bngqk",
                   q.reshape(b, kv, g, s, d).astype(np.float64),
                   k.astype(np.float64)) * d ** -0.5
    if causal:
        qpos, kpos = np.arange(s)[:, None], np.arange(s)[None, :]
        ok = (kpos <= qpos) & ((kpos > qpos - window) if window else True)
        sc = np.where(ok, sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    want = (m + np.log(np.exp(sc - m).sum(-1, keepdims=True)))[..., 0]
    p = np.exp(sc - want[..., None])
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert _err(lse, want.reshape(b, h, s)) <= FLASH_TOL
    assert _err(out, np.einsum("bngqk,bnkd->bngqd", p, v).reshape(
        b, h, s, d)) <= FLASH_TOL


@pytest.mark.parametrize("q_block", [flash_mod.FLASH_Q_BLOCK, 16])
@pytest.mark.parametrize("b,h,kv,s,d,causal,window", FLASH_CASES)
def test_flash_fn_backward_matches_autograd_and_jax(monkeypatch, q_block, b,
                                                    h, kv, s, d, causal,
                                                    window):
    """FlashAttentionFn's torch-op gradient (in blocks of 16 queries as in
    one block) against autograd through the plain version and jax.grad
    of ref.flash_attention_ref, for one random cotangent."""
    monkeypatch.setattr(flash_mod, "FLASH_Q_BLOCK", q_block)
    q, k, v = _flash_inputs(2, b, h, kv, s, d)
    w = np.random.default_rng(3).standard_normal((b, h, s, d),
                                                 dtype=np.float32)
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = FlashAttentionFn.apply(*leaves, causal, window, None)
    got = torch.autograd.grad((out * t(w)).sum(), leaves)
    plain = [t(a).requires_grad_(True) for a in (q, k, v)]
    out_p, _ = flash_attention_plain(*plain, causal=causal, window=window)
    want = torch.autograd.grad((out_p * t(w)).sum(), plain)
    jgrads = jax.grad(lambda qq, kk, vv: jnp.sum(ref.flash_attention_ref(
        qq, kk, vv, causal=causal, window=window) * w), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g_got, g_want, g_jax in zip(got, want, jgrads):
        assert g_got.dtype == torch.float32
        assert _rel(g_got, g_want) <= GRAD_TOL
        assert _rel(g_got, g_jax) <= GRAD_TOL


def test_flash_wrapper_refuses_without_a_launch():
    """On the CPU the wrapper runs the plain version and launches nothing;
    on another device, or with a head dim that is not contiguous or K and
    V of other strides, it raises before any launch."""
    _build.reset_launches()
    q, k, v = _flash_inputs(4, 1, 4, 2, 24, 16)
    flash_attention(t(q), t(k), t(v))
    assert _build.launches["flash_attention"] == 0
    mq = torch.empty((1, 4, 24, 16), device="meta")
    mk = torch.empty((1, 2, 24, 16), device="meta")
    with pytest.raises(ValueError):
        flash_attention(mq, mk, mk)
    with pytest.raises(ValueError):
        flash_attention(mq, mk.transpose(2, 3).contiguous().transpose(2, 3),
                        mk)
    assert all(n == 0 for n in _build.launches.values())


# ----------------------------------------------------------------------
# the norms' gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(8, 96), (2, 5, 128)])
def test_rmsnorm_fns_backward_match_autograd_and_jax(shape):
    rng = np.random.default_rng(5)
    x, dl, dout, dr = (rng.standard_normal(shape, dtype=np.float32)
                       for _ in range(4))
    sc = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    eps = 1e-5
    # rmsnorm: the Function, autograd through the plain version, jax.grad
    xs, ss = t(x).requires_grad_(True), t(sc).requires_grad_(True)
    got = torch.autograd.grad((RmsNormFn.apply(xs, ss, eps, None)
                               * t(dout)).sum(), [xs, ss])
    xp, sp = t(x).requires_grad_(True), t(sc).requires_grad_(True)
    want = torch.autograd.grad((rmsnorm_plain(xp, sp, eps) * t(dout)).sum(),
                               [xp, sp])
    jgot = jax.grad(lambda xx, s_: jnp.sum(jlayers.rmsnorm(
        {"scale": s_}, xx, eps) * dout), argnums=(0, 1))(jnp.asarray(x),
                                                         jnp.asarray(sc))
    for a, b_, c in zip(got, want, jgot):
        assert _rel(a, b_) <= GRAD_TOL and _rel(a, c) <= GRAD_TOL
    # add_rmsnorm: both outputs carry a gradient
    xs, ds, ss = (t(a).requires_grad_(True) for a in (x, dl, sc))
    r, out = AddRmsNormFn.apply(xs, ds, ss, eps, None)
    got = torch.autograd.grad((r * t(dr)).sum() + (out * t(dout)).sum(),
                              [xs, ds, ss])
    xp, dp, sp = (t(a).requires_grad_(True) for a in (x, dl, sc))
    r, out = add_rmsnorm_plain(xp, dp, sp, eps)
    want = torch.autograd.grad((r * t(dr)).sum() + (out * t(dout)).sum(),
                               [xp, dp, sp])

    def jfn(xx, dd, s_):
        rr = xx + dd
        return jnp.sum(rr * dr) + jnp.sum(jlayers.rmsnorm({"scale": s_}, rr,
                                                          eps) * dout)
    jgot = jax.grad(jfn, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(dl),
                                            jnp.asarray(sc))
    for a, b_, c in zip(got, want, jgot):
        assert _rel(a, b_) <= GRAD_TOL and _rel(a, c) <= GRAD_TOL


# ----------------------------------------------------------------------
# Model.forward(mode="train"), loss_fn, the train step
# ----------------------------------------------------------------------
def _gemma_pair():
    return jget_smoke("gemma3-12b"), get_smoke_config("gemma3-12b")


PAIRS = {"mha": lambda: config_pair("mha"), "gqa": lambda: config_pair("gqa"),
         "gemma3": _gemma_pair}


@pytest.fixture(scope="module", params=list(PAIRS))
def setup(request):
    jc, tc = PAIRS[request.param]()
    npp = jax_params(jc, seed=1)
    # gemma3's smoke window is 32: S = 48 reaches past it
    toks = np.random.default_rng(6).integers(
        0, jc.vocab_size, (2, 48)).astype(np.int32)
    return jc, tc, npp, toks


def test_train_logits_match_jax(setup):
    jc, tc, npp, toks = setup
    if jc.window:
        assert toks.shape[1] > jc.window
    jm = build_model(jc)
    want, _, jaux = jm.forward(jax.tree_util.tree_map(jnp.asarray, npp),
                               {"tokens": jnp.asarray(toks)})
    got, cache, aux = Model(tc, device="cpu").forward(
        bridged(npp, tc), {"tokens": t(toks)})
    assert cache is None and set(aux) == set(jaux)
    assert all(float(v) == 0.0 for v in aux.values())
    assert got.shape == want.shape
    assert _err(got.detach(), want) <= LOGIT_TOL


def test_loss_and_every_gradient_leaf_match_jax(setup):
    jc, tc, npp, toks = setup
    jm = build_model(jc)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(jm, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, npp))
    loss, metrics, grads = value_and_grad(Model(tc, device="cpu"),
                                          bridged(npp, tc),
                                          {"tokens": t(toks)})
    assert abs(float(loss) - float(jloss)) <= GRAD_TOL * abs(float(jloss))
    assert abs(float(metrics["ce"]) - float(jmetrics["ce"])) <= (
        GRAD_TOL * abs(float(jmetrics["ce"])))
    want = dict(flatten(jax.tree_util.tree_map(np.asarray, jgrads)))
    got = dict(flatten(params_to_numpy(grads, tc)))
    assert got.keys() == want.keys()
    for path, g in want.items():
        assert _rel(got[path], g) <= GRAD_TOL, path


def test_three_train_steps_match_the_jitted_jax_step(setup):
    jc, tc, npp, toks = setup
    jm = build_model(jc)
    jstep = jax.jit(jmake_step(jm, base_lr=3e-3, warmup=2, total_steps=10))
    tstep = make_train_step(Model(tc, device="cpu"), base_lr=3e-3, warmup=2,
                            total_steps=10)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    tp = bridged(npp, tc)
    jo, to = jadamw_init(jp), adamw_init(tp)
    for i in range(3):
        batch = toks[:, ::-1].copy() if i == 1 else toks
        jp, jo, jm_ = jstep(jp, jo, {"tokens": jnp.asarray(batch)})
        tp, to, tm_ = tstep(tp, to, {"tokens": t(batch)})
        for key in ("ce", "loss", "grad_norm", "lr"):
            want = float(jm_[key])
            assert abs(float(tm_[key]) - want) <= STEP_RTOL * abs(want), (
                i, key)
    assert int(to.step) == int(jo.step) == 3


def test_adamw_update_on_identical_inputs():
    """The update, moments and clipped norm of the two packages from the
    same parameters, gradients and moments (a clip that binds)."""
    rng = np.random.default_rng(7)

    def tree(scale):
        return {"a": {"w": (scale * rng.standard_normal((6, 5))).astype(
                    np.float32)},
                "b": [(scale * rng.standard_normal(7)).astype(np.float32)]}
    p, g, m = tree(1.0), tree(3.0), tree(0.1)
    v = jax.tree_util.tree_map(np.abs, tree(0.1))
    for step in (0, 5):
        jstate = jadamw_init(p)._replace(
            step=jnp.asarray(step, jnp.int32),
            mu=jax.tree_util.tree_map(jnp.asarray, m),
            nu=jax.tree_util.tree_map(jnp.asarray, v))
        jp, js, jn = jadamw_update(jax.tree_util.tree_map(jnp.asarray, g),
                                   jstate, jax.tree_util.tree_map(
                                       jnp.asarray, p), lr=2e-3)
        tmap = lambda tr: {"a": {"w": t(tr["a"]["w"])},  # noqa: E731
                           "b": [t(tr["b"][0])]}
        tstate = AdamWState(step=torch.tensor(step, dtype=torch.int32),
                            mu=tmap(m), nu=tmap(v))
        tp, ts, tn = adamw_update(tmap(g), tstate, tmap(p), lr=2e-3)
        assert int(ts.step) == int(js.step) == step + 1
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            for (pg, a), (pw, b_) in zip(flatten(got), flatten(
                    jax.tree_util.tree_map(np.asarray, want))):
                assert pg == pw and _err(a, b_) <= 1e-6, pg


def test_cosine_lr_matches_jax():
    for warmup, total in ((2, 8), (100, 10_000), (0, 1)):
        for step in (0, 1, 2, 3, 7, 8, 50, 99, 100, 5000, 9999, 20000):
            want = float(jcosine_lr(jnp.asarray(step, jnp.int32), 3e-4,
                                    warmup, total))
            got = cosine_lr(torch.tensor(step, dtype=torch.int32), 3e-4,
                            warmup, total)
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-7 * want, (warmup, step)


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 64, 8, 0),
                                                  (49152, 256, 4, 3),
                                                  (100, 10, 3, 1)])
def test_synthetic_lm_batches_equal_the_reference(vocab, seq, batch, seed):
    ours, theirs = (cls(vocab, seq, batch, seed=seed)
                    for cls in (SyntheticLM, JSyntheticLM))
    for step, shard, n_shards in ((0, 0, 1), (5, 1, 2), (17, 3, 4)):
        if batch % n_shards:
            continue
        a = ours.batch_at(step, shard, n_shards)["tokens"]
        b_ = theirs.batch_at(step, shard, n_shards)["tokens"]
        assert a.dtype == b_.dtype == np.int32 and np.array_equal(a, b_)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_restore_both_ways(tmp_path, dtype):
    """A port checkpoint of params (and of an AdamW state) restores in the
    JAX package, and a JAX one in the port, leaf for leaf (bfloat16 too:
    the port writes it as float32, the reference as raw two-byte
    values)."""
    jc, tc = config_pair("gqa")
    jc, tc = (dataclasses.replace(c, dtype=dtype) for c in (jc, tc))
    jp = build_model(jc).init(jax.random.PRNGKey(2))
    npp = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp)
    tp = params_from_numpy(npp, tc, "cpu", getattr(torch, dtype))
    # port -> JAX
    path = str(tmp_path / "port.npz")
    tckpt.save(path, params_to_numpy(tp, tc))
    back = jckpt.restore(path, jp)
    for (pa, a), (pb, b_) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(jp)[0]):
        assert a.dtype == b_.dtype and np.array_equal(
            np.asarray(a, np.float32), np.asarray(b_, np.float32))
    opt = adamw_init(tp)
    opt = opt._replace(step=torch.tensor(4, dtype=torch.int32))
    tckpt.save(str(tmp_path / "opt.npz"), opt)
    jopt = jckpt.restore(str(tmp_path / "opt.npz"), jadamw_init(jp))
    assert int(jopt.step) == 4
    # JAX -> port
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jp)
    got = tckpt.restore(path, tp)
    for (pa, a), (pb, b_) in zip(flatten(got), flatten(tp)):
        assert pa == pb and a.dtype == b_.dtype and torch.equal(a, b_)
    with pytest.raises(ValueError):
        tckpt.restore(path, {"embed": tp["embed"]})


def test_a_jax_checkpoint_restores_through_the_bridge(tmp_path):
    """gemma3's smoke model stores each one-layer segment unstacked: a
    JAX checkpoint restores into the reference's numpy tree
    (``params_to_numpy``'s) and from there into port params through the
    bridge; into the port's own stacked tree it is refused by shape."""
    jc, tc = _gemma_pair()
    jp = build_model(jc).init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc,
                           "cpu", torch.float32)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jp)
    got = params_from_numpy(tckpt.restore(path, params_to_numpy(tp, tc)),
                            tc, "cpu", torch.float32)
    for (pa, a), (pb, b_) in zip(flatten(got), flatten(tp)):
        assert pa == pb and torch.equal(a, b_)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(path, tp)


def test_trainer_runs_on_the_cpu_and_its_ce_falls():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "20", "--log-every", "19"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    ces = [float(ln.split("ce=")[1].split()[0])
           for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert len(ces) == 2 and all(np.isfinite(ces)) and ces[1] < ces[0]


def test_train_mode_refuses_mamba1_and_prefill():
    mamba = get_smoke_config("falcon-mamba-7b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttfm.check_supported(mamba, "train")
    ttfm.check_supported(mamba)                  # serving it is ported
    with pytest.raises(NotImplementedError):
        Model(mamba, device="cpu").forward(
            None, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    smollm = get_smoke_config("smollm-360m")
    with pytest.raises(NotImplementedError, match="prefill"):
        Model(smollm, device="cpu").forward(
            None, {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
            mode="prefill")
