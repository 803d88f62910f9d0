"""The port's side of tests/test_torch_distributed.py: four gloo ranks on
the CPU, one spawn for every case.

    python tests/_torch_dist.py INPUTS.npz OUT_DIR

Rank r writes ``OUT_DIR/rank{r}.pt``: its mesh coordinates, its outputs
of each distributed case (its own slice), its aux values, the form
``moe_apply`` chose under ``REPRO_MOE_SHARDMAP``, the specs
``param_specs`` gives its smoke models, the placements ``constrain``
gives a DTensor, and, where ``MODELS.pt`` lies beside the inputs, the
models of ``MODEL_CASES`` run on DTensor params (logits gathered).  Inputs come from the npz the test wrote with numpy.
Imports torch and the port only.
"""
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MOE_CASES = ("sharded_e4", "sharded_e4_roomy", "capsharded_e3",
             "capsharded_e3_roomy")
SPEC_ARCHS = ("smollm-360m", "mixtral-8x7b", "falcon-mamba-7b", "zamba2-7b")


def moe_config(case: str, inputs):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    e, cf = inputs[f"{case}/config"].tolist()
    return dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                               n_experts=int(e), experts_per_token=2,
                               capacity_factor=float(cf))


def moe_params(case: str, inputs) -> dict:
    return {k: torch.from_numpy(inputs[f"{case}/{k}"])
            for k in ("router", "we_gate", "we_up", "we_down")}


def _flat_specs(tree, prefix="", out=None):
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat_specs(v, f"{prefix}{k}/", out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _flat_specs(v, f"{prefix}{i}/", out)
    elif tree is not None:
        out[prefix[:-1]] = tuple(tree)
    return out


#: the models on DTensors (``MODELS.pt`` beside the inputs, which the test
#: writes): name -> (arch, config overrides, env)
MODEL_CASES = ("smollm_h3", "mixtral", "mixtral_shardmap", "mixtral_ep_dp",
               "mamba")
#: the model cases that also take one train step on the mesh
TRAIN_CASES = ("smollm_h3", "mixtral")
#: the train step's schedule: the first step at a visible rate
TRAIN_LR = dict(base_lr=1e-2, warmup=1)


def train_state(params):
    """The AdamW state the train step starts from: zero moments, but
    nu at 1e-2, so the update is close to g / sqrt(nu), linear in the
    gradient.  From nu = 0 it would be g / (|g| + eps), a sign, which a
    gradient near eps flips on the order of its sums."""
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.tree import tree_map
    state = adamw_init(params)
    return state._replace(nu=tree_map(lambda v: v + 1e-2, state.nu))


def _model_runs(meshes, models_path):
    """Each model case's train-mode forward logits and a decode step's
    logits after a prefill, on DTensor params on the 2x2 mesh under its
    rules (the whole tensors, gathered); for :data:`TRAIN_CASES` also
    one train step's loss, gradients, gradient norm and updated
    params."""
    import dataclasses
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import cache_spec
    from repro_torch.models.model import Model
    from repro_torch.sharding.specs import (PartitionSpec as P, fit_spec,
                                            param_specs, to_placements,
                                            use_mesh_rules)
    from repro_torch.training.train_step import (make_train_step,
                                                 value_and_grad)
    from repro_torch.training.tree import leaves
    mesh = meshes["2x2"]
    data = torch.load(models_path, weights_only=False)
    out = {}

    def dt(t, spec):
        spec = fit_spec(tuple(t.shape), spec, mesh)
        return distribute_tensor(t, mesh, to_placements(spec, mesh))

    def tree(params, specs):
        if isinstance(params, dict):
            return {k: tree(v, specs[k]) for k, v in params.items()}
        if isinstance(params, list):
            return [tree(v, s_) for v, s_ in zip(params, specs)]
        return None if params is None else dt(params, specs)

    for name in MODEL_CASES:
        arch, over, env = data[name]["case"]
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        model = Model(cfg, device="cpu")
        params = tree(data[name]["params"],
                      param_specs(data[name]["params"], mesh))
        tokens = data[name]["tokens"]
        b, s = tokens.shape
        for k, v in env.items():
            os.environ[k] = v
        with torch.no_grad(), use_mesh_rules(mesh), implicit_replication():
            logits, _, _ = model.forward(
                params, {"tokens": dt(tokens, P("data", None))}, mode="train")
            out[f"model/{name}/train"] = logits.full_tensor()
            caches = [{k: dt(v, cache_spec(k, v.ndim, mesh))
                       for k, v in c.items()}
                      for c in model.init_cache(b, s + 4)]
            model.forward(params, {"tokens": dt(tokens[:, :-1],
                                                P("data", None))},
                          mode="prefill", caches=caches)
            # the same caches laid out along their slots (the seq layout)
            seq = [{k: v.clone().redistribute(mesh, to_placements(fit_spec(
                tuple(v.shape), cache_spec(k, v.ndim, mesh, "seq"), mesh),
                mesh)) for k, v in c.items()} for c in caches]
            batch = {"token": dt(tokens[:, -1:], P("data", None)),
                     "pos": dt(torch.full((b,), s - 1, dtype=torch.int32),
                               P("data"))}
            logits, _ = model.decode_step(params, caches, batch)
            out[f"model/{name}/decode"] = logits.full_tensor()
            logits, _ = model.decode_step(params, seq, batch)
            out[f"model/{name}/decode_seq"] = logits.full_tensor()
        if name in TRAIN_CASES:
            batch = {"tokens": dt(tokens, P("data", None))}
            with use_mesh_rules(mesh), implicit_replication():
                _, _, grads = value_and_grad(model, params, batch)
                opt = train_state(params)
                opt = opt._replace(step=dt(opt.step, P()))
                new, _, metrics = make_train_step(model, **TRAIN_LR)(
                    params, opt, batch)
            out[f"model/{name}/train_step"] = {
                "loss": metrics["loss"].full_tensor(),
                "grad_norm": metrics["grad_norm"].full_tensor(),
                "grads": [g.full_tensor() for g in leaves(grads)],
                "params": [p.full_tensor() for p in leaves(new)]}
        for k in env:
            os.environ.pop(k)
    return out


def rank_main(rank: int, store_path: str, inputs_path: str, out_dir: str):
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.models import moe
    from repro_torch.serving.decode import (decode_specs,
                                            distributed_decode_attention)
    from repro_torch.sharding.specs import (PartitionSpec as P, constrain,
                                            local_shard, param_specs,
                                            use_mesh_rules)

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    meshes = {"2x2": init_device_mesh("cpu", (2, 2),
                                      mesh_dim_names=("data", "model")),
              "1x4": init_device_mesh("cpu", (1, 4),
                                      mesh_dim_names=("data", "model"))}
    inputs = np.load(inputs_path)
    out = {"coords": {k: list(m.get_coordinate()) for k, m in meshes.items()}}

    # seq-parallel flash-decode
    for case in ("decode", "decode_edges"):
        q, kc, vc, pos = (torch.from_numpy(inputs[f"{case}/{k}"])
                          for k in ("q", "k", "v", "pos"))
        # the reference's (B, KV, S, D) cache in the port's (B, S, KV, D)
        kc, vc = (c.permute(0, 2, 1, 3).contiguous() for c in (kc, vc))
        for name, mesh in meshes.items():
            qs, cs, ps = decode_specs(mesh)
            got = distributed_decode_attention(
                local_shard(q, qs, mesh), local_shard(kc, cs, mesh).contiguous(),
                local_shard(vc, cs, mesh).contiguous(),
                local_shard(pos, ps, mesh), mesh)
            out[f"{case}/{name}"] = got

    # the sharded MoE forms, called directly on the 2x2 mesh
    mesh = meshes["2x2"]
    for case in MOE_CASES:
        cfg = moe_config(case, inputs)
        params = moe_params(case, inputs)
        x = local_shard(torch.from_numpy(inputs[f"{case}/x"]),
                        P("data", None, None), mesh)
        if case.startswith("sharded"):
            params.update({k: local_shard(params[k], P("model", None, None),
                                          mesh)
                           for k in ("we_gate", "we_up", "we_down")})
            y, aux = moe.moe_apply_sharded(params, x, cfg, mesh)
        else:
            y, aux = moe.moe_apply_capsharded(params, x, cfg, mesh)
        out[f"{case}/y"] = y
        out[f"{case}/aux"] = {k: float(v) for k, v in aux.items()}

    # moe_apply's selection under REPRO_MOE_SHARDMAP (whole experts: the
    # sharded form takes its range)
    chosen = {}
    reals = {form: getattr(moe, form)
             for form in ("moe_apply_sharded", "moe_apply_capsharded")}
    for form in ("moe_apply_sharded", "moe_apply_capsharded"):
        real = getattr(moe, form)

        def spy(*a, _real=real, _form=form, **kw):
            chosen[current] = _form
            return _real(*a, **kw)
        setattr(moe, form, spy)
    for case in ("sharded_e4", "capsharded_e3"):
        current = case
        cfg = moe_config(case, inputs)
        x = local_shard(torch.from_numpy(inputs[f"{case}/x"]),
                        P("data", None, None), mesh)
        os.environ.pop("REPRO_MOE_SHARDMAP", None)
        with use_mesh_rules(mesh):
            moe.moe_apply(moe_params(case, inputs), x, cfg)
        chosen.setdefault(case + "/unset", chosen.pop(case, "moe_apply"))
        os.environ["REPRO_MOE_SHARDMAP"] = "1"
        with use_mesh_rules(mesh):
            y, _ = moe.moe_apply(moe_params(case, inputs), x, cfg)
        out[f"{case}/selected_y"] = y
        os.environ.pop("REPRO_MOE_SHARDMAP")
    out["selection"] = chosen
    for form, real in reals.items():      # the spies end here
        setattr(moe, form, real)

    # param_specs of the smoke models on the real 2x2 mesh
    if rank == 0:
        from repro_torch.configs import get_smoke_config
        from repro_torch.models.model import Model
        specs = {}
        for arch in SPEC_ARCHS:
            model = Model(get_smoke_config(arch), device="cpu")
            params = model.init(torch.Generator().manual_seed(0))
            flat = _flat_specs(param_specs(params, mesh))
            shapes = _flat_specs(_shapes(params))
            specs[arch] = {p: (s, shapes[p]) for p, s in flat.items()}
        out["param_specs"] = specs

    # constrain: a replicated DTensor to the rule's placements
    x = distribute_tensor(torch.arange(4 * 8 * 6, dtype=torch.float32)
                          .reshape(4, 8, 6), mesh, [Replicate(), Replicate()])
    odd = distribute_tensor(torch.ones((3, 8, 6)), mesh,
                            [Replicate(), Replicate()])
    with use_mesh_rules(mesh):
        btf = constrain(x, "act_btf")
        btd = constrain(odd, "act_btd")
    out["constrain"] = {"act_btf": _sharded_dims(btf.placements),
                        "act_btf_local": list(btf.to_local().shape),
                        "act_btf_value": btf.full_tensor(),
                        "act_btd_odd": _sharded_dims(btd.placements)}
    models = os.path.join(os.path.dirname(inputs_path), "MODELS.pt")
    if os.path.exists(models):
        out.update(_model_runs(meshes, models))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _sharded_dims(placements) -> list:
    """Each mesh dim's sharded tensor dim, None where it replicates."""
    return [p.dim if p.is_shard() else None for p in placements]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return None if tree is None else tuple(tree.shape)


def main(inputs_path: str, out_dir: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(os.path.join(tmp, "store"), inputs_path,
                                  out_dir), nprocs=WORLD)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
