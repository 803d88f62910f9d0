"""The gradients the port added to train every family, against autograd
and the live JAX package, on the CPU; checkpoints of the MoE, Mamba2
and encoder-decoder trees; the trainer and the quickstart on the CPU.

Inputs come from numpy seeds.  Tolerances (``GRAD_TOL``, as
test_torch_train.py's): 1e-5 of max(1, |g|) for every gradient (f32 sums
in another order: the reverse scan accumulates its state gradient step
by step, autograd and ``jax.grad`` through their own graphs), and the
forward outputs within the same bound.
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

from _torch_ref import TORCH_THREADS, jax_params  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import selective_scan as scan_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    CrossAttentionFn, paged_cross_attention_plain)
from repro_torch.kernels.selective_scan import (  # noqa: E402
    SCAN_CKPT_STEPS, SelectiveScanFn, scan_checkpoints,
    selective_scan_backward, selective_scan_backward_plain,
    selective_scan_plain)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training.tree import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-5
SCAN_NAMES = ("dt", "b_mat", "c_mat", "x", "a_neg", "h0")


def t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b) -> float:
    """Largest difference relative to max(1, |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))


# ----------------------------------------------------------------------
# the selective scan's gradient
# ----------------------------------------------------------------------
def _scan_inputs(seed, b, t_, di, ds, h0_zero):
    """Inputs in the model's range: dt a softplus around the init's
    ``dt_bias`` of -2, A = -exp(A_log) around Mamba1's init of
    ``log(1..d_state)``.  (Where dt·A is near zero for every step, the
    state gradient sums hundreds of terms of one sign; dA then reaches
    several hundred, and autograd and jax.grad in float32 differ from a
    float64 sum by up to 3e-5 of it.)"""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    dt = np.log1p(np.exp(f32(b, t_, di) - 2)).astype(np.float32)
    a_neg = -np.exp(np.log(np.arange(1, ds + 1, dtype=np.float32))
                    + 0.3 * f32(di, ds)).astype(np.float32)
    h0 = np.zeros((b, di, ds), np.float32) if h0_zero else f32(b, di, ds)
    return ((dt, f32(b, t_, ds), f32(b, t_, ds), f32(b, t_, di), a_neg, h0),
            f32(b, t_, di), f32(b, di, ds))


def _jax_scan_grads(inputs, dy, dh):
    """jax.grad of sum(y dy) + sum(h_T dh) through the reference's
    ``_mamba1_scan_step`` under ``lax.scan``."""
    def loss(dt, b_mat, c_mat, x, a_neg, h0):
        xs = tuple(jnp.moveaxis(v, 1, 0) for v in (dt, b_mat, c_mat, x))
        h_t, ys = jax.lax.scan(
            lambda h, inp: jssm._mamba1_scan_step(h, inp, a_neg), h0, xs)
        return jnp.sum(jnp.moveaxis(ys, 0, 1) * dy) + jnp.sum(h_t * dh)
    return jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(v) for v in inputs))


# d_state 16 (falcon-mamba) and 64 (zamba2), and 5 (a lane's states
# ragged); h0 zero (training) and not; T below, at and past one
# checkpoint's 32 steps, a multiple of it and not
SCAN_GRAD_CASES = [(2, 20, 12, 16, True), (2, 32, 12, 16, False),
                   (1, 70, 9, 16, False), (2, 64, 6, 64, True),
                   (1, 45, 5, 64, False), (2, 33, 7, 5, True)]


@pytest.mark.parametrize("b,t_,di,ds,h0_zero", SCAN_GRAD_CASES)
def test_scan_backward_plain_matches_autograd_and_jax(b, t_, di, ds,
                                                      h0_zero):
    """``selective_scan_backward_plain`` (from the forward's checkpoints,
    with a nonzero dh_T) equals autograd through ``selective_scan_plain``
    and jax.grad of the reference's scan; the checkpoints are the states
    before every 32 steps."""
    inputs, dy, dh = _scan_inputs(11, b, t_, di, ds, h0_zero)
    ckpt = torch.empty((b, scan_checkpoints(t_), di, ds))
    y, h_t = selective_scan_plain(*map(t, inputs), checkpoints=ckpt)
    assert ckpt.shape[1] == -(-t_ // SCAN_CKPT_STEPS)
    assert torch.equal(ckpt[:, 0], t(inputs[5]))
    if t_ > SCAN_CKPT_STEPS:
        _, h_32 = selective_scan_plain(*(t(v[:, :SCAN_CKPT_STEPS])
                                         for v in inputs[:4]),
                                       *map(t, inputs[4:]))
        assert torch.equal(ckpt[:, 1], h_32)
    got = selective_scan_backward_plain(*map(t, inputs[:5]), ckpt, t(dy),
                                        t(dh))
    leaves = [t(v).requires_grad_(True) for v in inputs]
    y_p, h_p = selective_scan_plain(*leaves)
    want = torch.autograd.grad((y_p * t(dy)).sum() + (h_p * t(dh)).sum(),
                               leaves)
    jgrads = _jax_scan_grads(inputs, dy, dh)
    assert torch.equal(y, y_p.detach()) and torch.equal(h_t, h_p.detach())
    for name, g, w, j in zip(SCAN_NAMES, got, want, jgrads):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _rel(g, w) <= GRAD_TOL, name
        assert _rel(g, j) <= GRAD_TOL, name
    # the wrapper takes the plain version for CPU tensors, launching
    # nothing
    _build.reset_launches()
    again = selective_scan_backward(*map(t, inputs[:5]), ckpt, t(dy), t(dh))
    assert all(torch.equal(a, b_) for a, b_ in zip(again, got))
    assert _build.launches["selective_scan_backward"] == 0


@pytest.mark.parametrize("b,t_,di,ds,h0_zero", SCAN_GRAD_CASES[::2])
def test_selective_scan_fn_gradient_equals_the_plain_one(b, t_, di, ds,
                                                         h0_zero):
    """SelectiveScanFn: the forward's (y, h_T) are the plain version's,
    the gradient the plain backward's (h_T unused: no dh_T), and h0 is
    read, never written."""
    inputs, dy, _ = _scan_inputs(12, b, t_, di, ds, h0_zero)
    leaves = [t(v).requires_grad_(True) for v in inputs]
    y, h_t = SelectiveScanFn.apply(*leaves)
    got = torch.autograd.grad((y * t(dy)).sum(), leaves)
    assert torch.equal(leaves[5].detach(), t(inputs[5]))
    want_y, want_h = selective_scan_plain(*map(t, inputs))
    assert torch.equal(y.detach(), want_y) and torch.equal(h_t.detach(),
                                                           want_h)
    ckpt = torch.empty((b, scan_checkpoints(t_), di, ds))
    selective_scan_plain(*map(t, inputs), checkpoints=ckpt)
    want = selective_scan_backward_plain(*map(t, inputs[:5]), ckpt, t(dy))
    for name, g, w in zip(SCAN_NAMES, got, want):
        assert torch.equal(g, w), name


def test_scan_backward_wrapper_refuses_without_a_launch():
    """Off the CPU the wrapper checks its tensors before any launch."""
    _build.reset_launches()
    m = torch.empty((1, 4, 8), device="meta")
    bc = torch.empty((1, 4, 16), device="meta")
    with pytest.raises(ValueError):
        selective_scan_backward(m, bc, bc, m, torch.empty((8, 16),
                                                          device="meta"),
                                torch.empty((1, 1, 8, 16), device="meta"), m)
    with pytest.raises(ValueError):
        scan_mod.bwd_lanes(65)
    assert [scan_mod.bwd_lanes(ds) for ds in (1, 4, 5, 16, 64)] == [
        1, 1, 2, 4, 16]
    assert all(n == 0 for n in _build.launches.values())


# ----------------------------------------------------------------------
# the cross form's gradient
# ----------------------------------------------------------------------
# (B, C, H, KV, src, q block): G 1 and G 2, a source not a multiple of
# 8, queries in blocks of 16 (C 37: a ragged last block) and in one
CROSS_GRAD_CASES = [(2, 37, 4, 4, 13, 16), (2, 37, 4, 2, 29, 16),
                    (1, 20, 6, 2, 50, 512)]


@pytest.mark.parametrize("b,c,h,kv,src,q_block", CROSS_GRAD_CASES)
def test_cross_fn_backward_matches_autograd_and_jax(monkeypatch, b, c, h, kv,
                                                    src, q_block):
    """CrossAttentionFn's dq / dk / dv equal autograd through the cross
    form's plain version over identity tables; through the model's
    ``cross_attention`` in train mode (projections included) every
    gradient equals jax.grad of the reference's ``cross_attention``."""
    monkeypatch.setattr(flash_mod, "FLASH_Q_BLOCK", q_block)
    rng = np.random.default_rng(13)
    hd = 16
    q = rng.standard_normal((b, c, h, hd), dtype=np.float32)
    k, v = (rng.standard_normal((b, src, kv, hd), dtype=np.float32)
            for _ in range(2))
    w = rng.standard_normal((b, c, h, hd), dtype=np.float32)
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = CrossAttentionFn.apply(*leaves)
    got = torch.autograd.grad((out * t(w)).sum(), leaves)
    plain = [t(a).requires_grad_(True) for a in (q, k, v)]
    tables = torch.arange(b, dtype=torch.int32)[:, None]
    out_p = paged_cross_attention_plain(*plain, tables, src)
    want = torch.autograd.grad((out_p * t(w)).sum(), plain)
    assert torch.equal(out.detach(), out_p.detach())
    for g, g_want in zip(got, want):
        assert _rel(g, g_want) <= GRAD_TOL
    # the model's cross read against the reference's, through wq / wo
    jc = dataclasses.replace(jget_smoke("llama-3.2-vision-90b"), n_heads=h,
                             n_kv_heads=kv, head_dim=hd)
    tc = dataclasses.replace(get_smoke_config("llama-3.2-vision-90b"),
                             n_heads=h, n_kv_heads=kv, head_dim=hd)
    p = jax.tree_util.tree_map(np.asarray, jattn.attention_init(
        jax.random.PRNGKey(5), jc, jnp.float32, cross=True))
    x = rng.standard_normal((b, c, jc.d_model), dtype=np.float32)
    wo = rng.standard_normal((b, c, jc.d_model), dtype=np.float32)

    def jloss(pp, xx, kk, vv):
        return jnp.sum(jattn.cross_attention(dict(p, **pp), xx,
                                             {"k": kk, "v": vv}, jc) * wo)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        {n: jnp.asarray(p[n]) for n in ("wq", "wo")}, jnp.asarray(x),
        jnp.asarray(k), jnp.asarray(v))
    # a cross read projects only its queries (wq) and output (wo): the
    # source K/V come projected
    tp = {n: t(p[n]).requires_grad_(True) for n in ("wq", "wo")}
    tx, tk, tv = (t(a).requires_grad_(True) for a in (x, k, v))
    out = tattn.cross_attention(tp, tx, {"k": tk, "v": tv}, tc, train=True)
    tg = torch.autograd.grad((out * t(wo)).sum(), [*tp.values(), tx, tk, tv])
    for name, g in zip(list(tp) + ["x", "k", "v"], tg):
        want_g = jg[0][name] if name in tp else jg[1 + "xkv".index(name)]
        assert _rel(g, want_g) <= GRAD_TOL, name


# ----------------------------------------------------------------------
# checkpoints of the new families' trees
# ----------------------------------------------------------------------
CKPT_PAIRS = {"mixtral-8x7b": {},
              "zamba2-7b": dict(n_layers=4, block_pattern=(
                  "mamba2", "attn", "mamba2", "attn")),
              "seamless-m4t-medium": {}}


@pytest.mark.parametrize("arch", list(CKPT_PAIRS))
def test_family_trees_round_trip_through_checkpoints(tmp_path, arch):
    """A MoE, a Mamba2 (the shared set once) and an encoder-decoder tree:
    port params -> ``params_to_numpy`` -> ``checkpoint.save`` ->
    ``restore`` -> ``params_from_numpy`` gives the same tensors, and so
    does the port's own stacked tree saved and restored as it is."""
    cfg = dataclasses.replace(get_smoke_config(arch), **CKPT_PAIRS[arch])
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    path = str(tmp_path / "ref_layout.npz")
    tckpt.save(path, params_to_numpy(params, cfg))
    back = params_from_numpy(tckpt.restore(path, params_to_numpy(params,
                                                                 cfg)),
                             cfg, "cpu", torch.float32)
    own = str(tmp_path / "port_layout.npz")
    tckpt.save(own, params)
    for got in (back, tckpt.restore(own, params)):
        pairs = list(zip(flatten(got), flatten(params)))
        assert len(pairs) == len(flatten(params))
        for (pa, a), (pb, b_) in pairs:
            assert pa == pb and a.dtype == b_.dtype and torch.equal(a, b_)


@pytest.mark.parametrize("arch", list(CKPT_PAIRS))
def test_family_jax_checkpoints_restore_through_the_bridge(tmp_path, arch):
    """A JAX checkpoint of each tree restores into the reference's numpy
    layout and through the bridge into port params equal to the bridged
    JAX params; a port checkpoint of them restores in the JAX package."""
    over = CKPT_PAIRS[arch]
    jc = dataclasses.replace(jget_smoke(arch), **over)
    tc = dataclasses.replace(get_smoke_config(arch), **over)
    jp = build_model(jc).init(jax.random.PRNGKey(4))
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc,
                             "cpu", torch.float32)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jp)
    got = params_from_numpy(tckpt.restore(path, params_to_numpy(want, tc)),
                            tc, "cpu", torch.float32)
    for (pa, a), (pb, b_) in zip(flatten(got), flatten(want)):
        assert pa == pb and torch.equal(a, b_)
    mine = str(tmp_path / "port.npz")
    tckpt.save(mine, params_to_numpy(want, tc))
    back = jckpt.restore(mine, jp)
    for a, b_ in zip(jax.tree_util.tree_leaves(back),
                     jax.tree_util.tree_leaves(jp)):
        assert np.array_equal(np.asarray(a), np.asarray(b_))


# ----------------------------------------------------------------------
# the trainer and the quickstart
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "falcon-mamba-7b",
                                  "llama-3.2-vision-90b"])
def test_trainer_trains_each_family_on_the_cpu(arch):
    """``launch/train.py --smoke --device cpu`` for a MoE, a Mamba and a
    cross config (the reference's zero frontend): ce finite and falling
    over 20 steps."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--device", "cpu", "--steps", "20", "--log-every", "19",
         "--batch", "4", "--seq", "32"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                           OMP_NUM_THREADS=str(TORCH_THREADS)),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    ces = [float(ln.split("ce=")[1].split()[0])
           for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert len(ces) == 2 and all(np.isfinite(ces)) and ces[1] < ces[0]


def test_quickstart_runs_on_the_cpu(tmp_path):
    """``examples/torch_quickstart.py``'s main at a few steps on the CPU:
    ce falls, the checkpoint round-trips, the engine generates."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_quickstart
    finally:
        sys.path.remove(str(ROOT / "examples"))
    ces, toks = torch_quickstart.main(steps=12, device="cpu",
                                      ckpt=str(tmp_path / "q.npz"),
                                      new_tokens=4)
    assert all(np.isfinite(ces)) and ces[-1] < ces[0]
    assert len(toks) == 4 and (tmp_path / "q.npz").exists()


# ----------------------------------------------------------------------
# chip_smoke.py's train launch formula against the wrappers' calls
# ----------------------------------------------------------------------
def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LAUNCH_PAIRS = {"smollm-360m": {}, "mixtral-8x7b": {},
                "falcon-mamba-7b": {}, "zamba2-7b": CKPT_PAIRS["zamba2-7b"],
                "llama-3.2-vision-90b": {}, "seamless-m4t-medium": {}}


@pytest.mark.parametrize("arch", list(LAUNCH_PAIRS))
def test_train_launch_formula_counts_the_wrappers(monkeypatch, arch):
    """One train step's calls of the kernel wrappers on the CPU (where
    each takes its plain version) are the launches
    ``chip_smoke.expected_train_launches`` expects on the card: the flash
    form, the cross form, the scan forward with checkpoints and its
    backward, and rmsnorm with and without the residual add."""
    from repro_torch.kernels import rmsnorm as norm_mod
    from repro_torch.training.train_step import value_and_grad
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_smoke_config(arch), **LAUNCH_PAIRS[arch])
    calls = dict.fromkeys(("flash_attention", "paged_cross_attention",
                           "selective_scan", "selective_scan_backward",
                           "norm", "add_norm"), 0)

    def counted(module, name, key):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)
    for module, name in ((flash_mod, "flash_attention"),
                         (flash_mod, "paged_cross_attention"),
                         (scan_mod, "selective_scan"),
                         (scan_mod, "selective_scan_backward")):
        counted(module, name, name)
    counted(norm_mod, "_rmsnorm", "norm")
    counted(norm_mod, "_add_rmsnorm", "add_norm")
    model = Model(cfg, device="cpu")
    batch = {"tokens": torch.zeros((2, 40), dtype=torch.int32)}
    src = cfg.encoder_seq if cfg.is_encoder_decoder else cfg.n_image_tokens
    if src:
        batch["frontend"] = torch.ones((2, src, cfg.d_model))
    value_and_grad(model, model.init(torch.Generator().manual_seed(0)),
                   batch)
    expect, bodies = cs.expected_train_launches(cfg, 1)
    assert {k: calls[k] for k in ("flash_attention", "paged_cross_attention",
                                  "selective_scan",
                                  "selective_scan_backward")} == {
        k: expect[k] for k in ("flash_attention", "paged_cross_attention",
                               "selective_scan", "selective_scan_backward")}
    assert calls["norm"] + calls["add_norm"] == expect["rmsnorm"]
    assert calls["norm"] == bodies["rmsnorm"]["norm"]
    assert calls["add_norm"] == bodies["rmsnorm"]["add_norm"]


@pytest.mark.parametrize("arch", list(LAUNCH_PAIRS))
def test_train_flash_launches_expect_wgmma(arch):
    """Every family's bf16 train launches of the contiguous flash form
    take ``wgmma`` at its full-size head dim (zamba2-7b's 112 on the
    hd-128 body since it took one): ``flash_body`` names it,
    ``chip_smoke.train_bodies`` agrees, and ``expected_train_launches``
    puts all of them on it."""
    from repro_torch.configs import get_config
    cs = _chip_smoke()
    cfg = get_config(arch)
    cs.train_bodies(cfg)
    steps = 3
    expect, bodies = cs.expected_train_launches(cfg, steps)
    assert bodies["flash_attention"] == {
        "wgmma": expect["flash_attention"], "mma": 0, "cuda_core": 0}
    if expect["flash_attention"]:
        assert flash_mod.flash_body(torch.bfloat16, cfg.head_dim) == "wgmma"
    if arch == "zamba2-7b":
        assert cfg.head_dim == 112
        assert expect["flash_attention"] == 2 * steps * sum(
            cfg.block_pattern.count(k) for k in ("attn", "swa"))


# (DI, d_state, lanes, blocks a row): 256 threads a block, 256 / G
# channels each; zamba2-7b's and falcon-mamba-7b's widths, and ragged ones
SCAN_BWD_GRIDS = [(7168, 64, 16, 448), (8192, 16, 4, 128),
                  (130, 5, 2, 2), (300, 64, 16, 19), (1, 1, 1, 1),
                  (96, 8, 2, 1)]


@pytest.mark.parametrize("di,ds,lanes,blocks", SCAN_BWD_GRIDS)
def test_scan_backward_grid(di, ds, lanes, blocks):
    """The backward kernel's grid mirrors (csrc/selective_scan.cu): G
    lanes of 4 states a channel, ``BWD_THREADS`` = 256 threads a block,
    so ``bwd_blocks`` = ceil(DI / (256 / G)) blocks a row, each writing
    one partial of dB and dC a step."""
    assert scan_mod.BWD_THREADS == 256 and scan_mod.BWD_LANE_STATES == 4
    assert scan_mod.bwd_lanes(ds) == lanes
    assert scan_mod.bwd_blocks(di, ds) == blocks
    assert blocks * (scan_mod.BWD_THREADS // lanes) >= di > (
        blocks - 1) * (scan_mod.BWD_THREADS // lanes)
