"""The port's scale-out plane on four ranks against the JAX package's.

Two subprocesses run side by side on the same numpy inputs (seeded):
the reference on 4 forced host devices (``XLA_FLAGS``, as
tests/test_distributed_decode.py runs it; the main test process keeps
seeing one device) and the port on 4 gloo CPU ranks of one spawn
(``tests/_torch_dist.py``, one thread a rank).  Meshes: 2x2 ``("data",
"model")`` for every case and 1x4 for the decode; rank r sits at the
row-major coordinate of r, as the reference's devices do.

Tolerances: 1e-5 in float32 (sums in another order across the ranks);
the aux values and the drop fraction of each rank equal the reference's
value on the same device (its ``out_specs=P()`` scalars are each
device's local value); the selection, the specs and the placements
exactly.  The plain partials equal ``_local_flash_decode`` within 1e-6
of max(1, |value|) (l sums up to 128 weights: float32's own step there
is a few 1e-6).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.kernels.decode_attention import (  # noqa: E402
    NEG_INF, dense_decode_attention_partial,
    dense_decode_attention_partial_plain)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
MOE_CASES = {"sharded_e4": (4, 0.5), "sharded_e4_roomy": (4, 4.0),
             "capsharded_e3": (3, 0.5), "capsharded_e3_roomy": (3, 4.0)}
SPEC_ARCHS = ("smollm-360m", "mixtral-8x7b", "falcon-mamba-7b", "zamba2-7b")

REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_smoke_config
    from repro.launch.steps import param_shardings
    from repro.models import build_model
    from repro.models import moe
    from repro.serving.decode import distributed_decode_attention
    from repro.sharding.specs import use_mesh_rules

    inputs = np.load(sys.argv[1])
    out_path, spec_path = sys.argv[2], sys.argv[3]
    devs = np.array(jax.devices()[:4])
    meshes = {"2x2": Mesh(devs.reshape(2, 2), ("data", "model")),
              "1x4": Mesh(devs.reshape(1, 4), ("data", "model"))}
    out = {}
    # one compile a mesh: both cases share their shapes
    decode = jax.jit(distributed_decode_attention, static_argnums=(4,))
    for case in ("decode", "decode_edges"):
        q, k, v, pos = (jnp.asarray(inputs[f"{case}/{n}"])
                        for n in ("q", "k", "v", "pos"))
        for name, mesh in meshes.items():
            out[f"{case}/{name}"] = np.asarray(decode(q, k, v, pos, mesh))
    mesh = meshes["2x2"]
    def per_device(a):
        vals = {s.device.id: float(np.asarray(s.data))
                for s in a.addressable_shards}
        return np.array([vals[d.id] for d in devs])
    for case in %(moe_cases)r:
        e, cf = inputs[f"{case}/config"].tolist()
        cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                                  n_experts=int(e), experts_per_token=2,
                                  capacity_factor=float(cf))
        params = {n: jnp.asarray(inputs[f"{case}/{n}"])
                  for n in ("router", "we_gate", "we_up", "we_down")}
        x = jnp.asarray(inputs[f"{case}/x"])
        form = (moe.moe_apply_sharded if case.startswith("sharded")
                else moe.moe_apply_capsharded)
        y, aux = jax.jit(lambda p, xx: form(p, xx, cfg, mesh))(params, x)
        out[f"{case}/y"] = np.asarray(y)
        for n, a in aux.items():
            out[f"{case}/{n}"] = per_device(a)

    chosen = {}
    for form in ("moe_apply_sharded", "moe_apply_capsharded"):
        real = getattr(moe, form)
        def spy(*a, _real=real, _form=form, **kw):
            chosen[current] = _form
            return _real(*a, **kw)
        setattr(moe, form, spy)
    for case in ("sharded_e4", "capsharded_e3"):
        current = case
        e, cf = inputs[f"{case}/config"].tolist()
        cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                                  n_experts=int(e), experts_per_token=2,
                                  capacity_factor=float(cf))
        params = {n: jnp.asarray(inputs[f"{case}/{n}"])
                  for n in ("router", "we_gate", "we_up", "we_down")}
        x = jnp.asarray(inputs[f"{case}/x"])
        for env in (None, "1"):
            current = case if env else case + "/unset"
            if env:
                os.environ["REPRO_MOE_SHARDMAP"] = env
            else:
                os.environ.pop("REPRO_MOE_SHARDMAP", None)
            with mesh, use_mesh_rules(mesh):
                y, _ = jax.jit(lambda p, xx: moe.moe_apply(p, xx, cfg))(
                    params, x)
            chosen.setdefault(current, "moe_apply")
        out[f"{case}/selected_y"] = np.asarray(y)
    os.environ.pop("REPRO_MOE_SHARDMAP", None)

    specs = {}
    for arch in %(spec_archs)r:
        model = build_model(get_smoke_config(arch))
        struct = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        shard = param_shardings(mesh, model, struct)
        leaves = {}
        def visit(path, sh, leaf):
            keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
            leaves["/".join(map(str, keys))] = (
                [list(a) if isinstance(a, tuple) else a for a in sh.spec],
                list(leaf.shape))
        jax.tree_util.tree_map_with_path(visit, shard, struct)
        specs[arch] = leaves
    np.savez(out_path, **out)
    with open(spec_path, "w") as f:
        json.dump({"selection": chosen, "specs": specs}, f)
    print("OK")
""") % {"moe_cases": tuple(MOE_CASES), "spec_archs": SPEC_ARCHS}


def _inputs(path: Path) -> dict:
    rng = np.random.default_rng(31)
    arrs = {}
    b, h, kv, s, d = 4, 8, 2, 256, 64
    for case, pos in (("decode", [3, 100, 255, 17]),
                      # shard edges on the 2x2 mesh's S_loc 128 (and the
                      # 1x4 mesh's 64): a model shard empty, one slot, a
                      # row at 0
                      ("decode_edges", [127, 128, 0, 64])):
        arrs[f"{case}/q"] = rng.standard_normal((b, h, d), dtype=np.float32)
        arrs[f"{case}/k"] = rng.standard_normal((b, kv, s, d),
                                                dtype=np.float32)
        arrs[f"{case}/v"] = rng.standard_normal((b, kv, s, d),
                                                dtype=np.float32)
        arrs[f"{case}/pos"] = np.array(pos, np.int32)
    from repro_torch.configs import get_smoke_config
    smoke = get_smoke_config("mixtral-8x7b")
    dm, f = smoke.d_model, smoke.moe_d_ff_eff
    for case, (e, cf) in MOE_CASES.items():
        arrs[f"{case}/config"] = np.array([e, cf], np.float64)
        arrs[f"{case}/router"] = rng.standard_normal((dm, e),
                                                     dtype=np.float32) * dm ** -0.5
        arrs[f"{case}/we_gate"] = rng.standard_normal((e, dm, f),
                                                      dtype=np.float32) * dm ** -0.5
        arrs[f"{case}/we_up"] = rng.standard_normal((e, dm, f),
                                                    dtype=np.float32) * dm ** -0.5
        arrs[f"{case}/we_down"] = rng.standard_normal((e, f, dm),
                                                      dtype=np.float32) * f ** -0.5
        arrs[f"{case}/x"] = rng.standard_normal((4, 32, dm), dtype=np.float32)
    np.savez(path, **arrs)
    return arrs


def _moe_config(case: str):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    e, cf = MOE_CASES[case]
    return dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                               n_experts=e, experts_per_token=2,
                               capacity_factor=cf)


#: models run on DTensor params on the 2x2 mesh (tests/_torch_dist.py):
#: name -> (arch, config overrides, environment).  smollm at 3 query heads
#: over 1 KV head: neither divides the model axis of 2 (the uneven
#: reshape of the flat projection, as 15 heads on 16); mixtral's 4
#: experts with room for every claim (no drops: capacity counted over
#: the whole batch and over a rank's rows agree), as DTensors and
#: through the sharded forms; falcon-mamba's Mamba1 layers
MODELS = {"smollm_h3": ("smollm-360m",
                        dict(n_heads=3, n_kv_heads=1, head_dim=32), {}),
          "mixtral": ("mixtral-8x7b", dict(capacity_factor=4.0), {}),
          "mixtral_shardmap": ("mixtral-8x7b", dict(capacity_factor=4.0),
                               {"REPRO_MOE_SHARDMAP": "1"}),
          "mixtral_ep_dp": ("mixtral-8x7b", dict(capacity_factor=4.0),
                            {"REPRO_MOE_LAYOUT": "ep_dp"}),
          "mamba": ("falcon-mamba-7b", {}, {})}


def _model_inputs(path: Path) -> dict:
    """Each model's weights (the reference's init, bridged) and tokens,
    saved where the ranks read them."""
    import dataclasses
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import build_model
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke_config
    rng = np.random.default_rng(32)
    out = {}
    for name, (arch, over, env) in MODELS.items():
        jc = dataclasses.replace(jax_smoke(arch), **over)
        tc = dataclasses.replace(get_smoke_config(arch), **over)
        jp = jax.tree_util.tree_map(
            np.asarray, build_model(jc).init(jax.random.PRNGKey(3)))
        out[name] = {"case": (arch, over, env),
                     "params": params_from_numpy(jp, tc, "cpu",
                                                 torch.float32),
                     "tokens": torch.from_numpy(rng.integers(
                         0, tc.vocab_size, (4, 16)).astype(np.int64))}
    torch.save(out, path)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both subprocesses, started together: (inputs, the reference's
    arrays, its selection and specs, the port's per-rank records)."""
    tmp = tmp_path_factory.mktemp("dist")
    inputs = _inputs(tmp / "inputs.npz")
    inputs["models"] = _model_inputs(tmp / "MODELS.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    (tmp / "port").mkdir()
    procs = [
        subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp / "inputs.npz"),
                          str(tmp / "ref.npz"), str(tmp / "ref.json")],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True),
        subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist.py"),
                          str(tmp / "inputs.npz"), str(tmp / "port")],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    ref = dict(np.load(tmp / "ref.npz"))
    meta = json.loads((tmp / "ref.json").read_text())
    port = [torch.load(tmp / "port" / f"rank{r}.pt", weights_only=False)
            for r in range(4)]
    return inputs, ref, meta, port


def _rows(rank_rec, mesh: str, b: int) -> slice:
    """The rows of a batch of ``b`` a rank holds on ``mesh``."""
    data = rank_rec["coords"][mesh][0]
    n_data = 2 if mesh == "2x2" else 1
    step = b // n_data
    return slice(data * step, (data + 1) * step)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("case", ["decode", "decode_edges"])
def test_distributed_decode_equals_reference(runs, case, mesh):
    """Every rank's rows of ``distributed_decode_attention`` equal the
    reference's (its shard_map over the same mesh) within 1e-5, every
    model rank of a data row alike (the combine leaves them replicated),
    and the single-host oracle too."""
    inputs, ref, _, port = runs
    want = ref[f"{case}/{mesh}"]
    b = want.shape[0]
    for rec in port:
        got = rec[f"{case}/{mesh}"].numpy()
        assert got.dtype == np.float32
        assert np.max(np.abs(got - want[_rows(rec, mesh, b)])) < TOL
    q, k, v, pos = (torch.from_numpy(inputs[f"{case}/{n}"])
                    for n in ("q", "k", "v", "pos"))
    from repro_torch.kernels.decode_attention import (
        dense_decode_attention_plain)
    oracle = dense_decode_attention_plain(
        q, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), pos).numpy()
    assert np.max(np.abs(oracle - want)) < TOL


def test_decode_edges_leave_a_model_shard_empty(runs):
    """The edge case's rows at pos 127 and 0 leave the 2x2 mesh's second
    model shard (slots 128-255) with no valid slot: the combine must
    weigh its partial (m = NEG_INF, l = 0) to nothing."""
    inputs, *_ = runs
    pos = inputs["decode_edges/pos"]
    assert (pos < 128).sum() >= 2 and (pos == 128).any()


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_sharded_moe_equals_reference(runs, case):
    """``moe_apply_sharded`` (E 4 on a model axis of 2: two experts a
    rank) and ``moe_apply_capsharded`` (E 3: every expert, half of each
    one's places a rank), called directly, against the reference's: y
    within 1e-5 on every rank's rows, and each rank's aux loss and drop
    fraction the reference's on the same device (each device's local
    value: data ranks differ, model ranks agree).  The tight capacity
    factor (0.5) drops claims; the roomy one (4.0) drops none."""
    inputs, ref, _, port = runs
    want = ref[f"{case}/y"]
    for r, rec in enumerate(port):
        got = rec[f"{case}/y"].numpy()
        assert np.max(np.abs(got - want[_rows(rec, "2x2", 4)])) < TOL
        for name in ("moe_aux_loss", "moe_drop_frac"):
            assert abs(rec[f"{case}/aux"][name] - ref[f"{case}/{name}"][r]) < TOL
        assert rec[f"{case}/aux"]["moe_drop_frac"] == pytest.approx(
            ref[f"{case}/moe_drop_frac"][r], abs=0)
    drops = ref[f"{case}/moe_drop_frac"]
    assert (drops > 0).all() if case.endswith(("e4", "e3")) else (
        drops == 0).all()
    assert drops[0] == drops[1] and drops[2] == drops[3]
    if case.endswith("roomy"):
        # nothing dropped: the forms compute what the port's single-host
        # moe_apply computes over each data rank's tokens
        from repro_torch.models.moe import moe_apply
        cfg = _moe_config(case)
        params = {n: torch.from_numpy(inputs[f"{case}/{n}"])
                  for n in ("router", "we_gate", "we_up", "we_down")}
        x = torch.from_numpy(inputs[f"{case}/x"])
        for rows in (slice(0, 2), slice(2, 4)):
            y, _ = moe_apply(params, x[rows], cfg)
            assert np.max(np.abs(y.numpy() - want[rows])) < TOL


def test_moe_apply_selects_the_reference_form(runs):
    """Under ``REPRO_MOE_SHARDMAP`` and a 2x2 mesh, ``moe_apply`` takes
    the expert-parallel form for E 4 and the capacity-sharded one for E
    3, as the reference's does (and neither without the variable); its
    outputs equal the reference's."""
    _, ref, meta, port = runs
    want = meta["selection"]
    assert want == {"sharded_e4": "moe_apply_sharded",
                    "sharded_e4/unset": "moe_apply",
                    "capsharded_e3": "moe_apply_capsharded",
                    "capsharded_e3/unset": "moe_apply"}
    for rec in port:
        assert rec["selection"] == want
        for case in ("sharded_e4", "capsharded_e3"):
            got = rec[f"{case}/selected_y"].numpy()
            assert np.max(np.abs(got - ref[f"{case}/selected_y"][
                _rows(rec, "2x2", 4)])) < TOL


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_param_specs_on_the_4_rank_mesh_equal_reference(runs, arch):
    """``param_specs`` of the port's smoke model on the real 2x2
    DeviceMesh against the reference's ``param_shardings`` on its 2x2
    Mesh: equal for every leaf, with one leading None where the port
    keeps a layer dim of 1 the reference leaves out."""
    _, _, meta, port = runs
    want = meta["specs"][arch]
    got = port[0]["param_specs"][arch]
    assert set(got) == set(want)
    for path, (spec, shape) in want.items():
        spec = tuple(tuple(a) if isinstance(a, list) else a for a in spec)
        spec = spec + (None,) * (len(shape) - len(spec))
        g_spec, g_shape = got[path]
        if len(g_shape) == len(shape) + 1:
            assert g_shape == (1, *shape) and g_spec == (None, *spec), path
        else:
            assert g_shape == tuple(shape) and g_spec == spec, path


def test_constrain_redistributes_a_dtensor(runs):
    """Under the 2x2 mesh's rules ``act_btf`` shards (4, 8, 6) on batch
    (data) and d_ff (model): a (2, 8, 3) block a rank, the whole tensor
    unchanged; ``act_btd`` over a batch of 3, which does not divide the
    data axis, drops it: replicated."""
    *_, port = runs
    whole = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    for rec in port:
        c = rec["constrain"]
        assert c["act_btf"] == [0, 2]            # Shard(0), Shard(2)
        assert c["act_btf_local"] == [2, 8, 3]
        assert torch.equal(c["act_btf_value"], whole)
        assert c["act_btd_odd"] == [None, None]    # Replicate() twice


@pytest.mark.parametrize("s_start", [0, 128])
def test_plain_partials_equal_local_flash_decode(s_start):
    """The partials form's plain version (the CPU path of
    ``dense_decode_attention_partial``) against the reference's
    ``_local_flash_decode`` on the same slice of 128 slots, within 1e-6
    of max(1, |value|):
    rows whose slice is empty (pos before it), full (pos past it) and
    partial; an empty row exactly (m = NEG_INF, l = 0, acc = 0)."""
    import jax.numpy as jnp
    from repro.serving.decode import _local_flash_decode
    rng = np.random.default_rng(37)
    b, h, kv, s, d = 5, 8, 2, 128, 64
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    k = rng.standard_normal((b, kv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, kv, s, d), dtype=np.float32)
    pos = np.array([s_start - 1 if s_start else 0, s_start + s + 9,
                    s_start + 40, s_start, s_start + s - 1], np.int32)
    want = _local_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), s_start=s_start,
                               scale=d ** -0.5)
    args = (torch.from_numpy(q),
            torch.from_numpy(k).permute(0, 2, 1, 3).contiguous(),
            torch.from_numpy(v).permute(0, 2, 1, 3).contiguous(),
            torch.from_numpy(pos))
    got = dense_decode_attention_partial_plain(*args, s_start)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        w = np.asarray(w)
        assert np.max(np.abs(g.numpy() - w)
                      / np.maximum(1.0, np.abs(w))) < 1e-6
    # on CPU tensors the wrapper is its plain version
    assert all(torch.equal(a, w) for a, w in zip(
        got, dense_decode_attention_partial(*args, s_start)))
    acc, m, l = got
    if s_start:
        assert bool((m[0] == np.float32(NEG_INF)).all())
        assert bool((l[0] == 0).all()) and bool((acc[0] == 0).all())
    assert bool((l[1:] > 0).all())


def _single_process(name, data):
    """The port's train-mode forward logits and the decode step's after
    a prefill, in one process on plain tensors."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    arch, over, _ = data["case"]
    model = Model(dataclasses.replace(get_smoke_config(arch), **over),
                  device="cpu")
    params, tokens = data["params"], data["tokens"]
    b, s = tokens.shape
    with torch.no_grad():
        train, _, _ = model.forward(params, {"tokens": tokens}, mode="train")
        caches = model.init_cache(b, s + 4)
        model.forward(params, {"tokens": tokens[:, :-1]}, mode="prefill",
                      caches=caches)
        decode, _ = model.decode_step(params, caches, {
            "token": tokens[:, -1:],
            "pos": torch.full((b,), s - 1, dtype=torch.int32)})
    return {"train": train, "decode": decode}


@pytest.mark.parametrize("name", list(MODELS))
def test_models_on_dtensors_equal_single_process(runs, name):
    """DTensor params on the 2x2 mesh under its rules (the ``constrain``
    calls, the heads' uneven reshape, the attention, norm and scan
    kernels' wrappers on each rank's rows and heads, the MoE on
    DTensors and its sharded forms): the train-mode forward's logits and
    a decode step's after a prefill, over caches laid out by heads and
    along their slots (the seq-parallel flash-decode), equal the
    single-process port's on the same weights (the reference's, bridged)
    within 1e-5 on every rank."""
    inputs, *_, port = runs
    want = _single_process(name, inputs["models"][name])
    want["decode_seq"] = want["decode"]
    for rec in port:
        for kind in ("train", "decode", "decode_seq"):
            got = rec[f"model/{name}/{kind}"]
            assert got.shape == want[kind].shape
            err = (got - want[kind]).abs().max().item()
            assert err < TOL, (name, kind, err)


@pytest.mark.parametrize("name", ["smollm_h3", "mixtral"])
def test_train_step_on_dtensors_equals_single_process(runs, name):
    """One train step (``make_train_step``) on DTensor params on the 2x2
    mesh under its rules: the loss (the cross entropy's target logits
    read from a vocab-sharded head), every gradient (through the
    kernels' islands and their gradient placements), the gradient norm
    and the updated params, gathered, equal the single-process step's
    on the same weights within 1e-5 on every rank.  The step starts from
    ``train_state``'s nu, where the update is linear in the gradient."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.training.train_step import (make_train_step,
                                                 value_and_grad)
    from repro_torch.training.tree import leaves
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_dist import TRAIN_LR, train_state
    inputs, *_, port = runs
    data = inputs["models"][name]
    arch, over, _ = data["case"]
    model = Model(dataclasses.replace(get_smoke_config(arch), **over),
                  device="cpu")
    params, batch = data["params"], {"tokens": data["tokens"]}
    _, _, grads = value_and_grad(model, params, batch)
    new, _, metrics = make_train_step(model, **TRAIN_LR)(
        params, train_state(params), batch)
    want = {"loss": [metrics["loss"]], "grad_norm": [metrics["grad_norm"]],
            "grads": leaves(grads), "params": leaves(new)}
    assert max(float(g.abs().max()) for g in want["grads"]) > 1e-3
    for rec in port:
        got = rec[f"model/{name}/train_step"]
        for kind, w in want.items():
            g = got[kind] if isinstance(got[kind], list) else [got[kind]]
            assert len(g) == len(w), (name, kind)
            for a, b in zip(g, w):
                assert a.shape == b.shape, (name, kind)
                err = (a - b).abs().max().item()
                assert err < TOL, (name, kind, err)
