"""The port's side of tests/test_torch_distributed.py: four gloo ranks on
the CPU, one spawn for every case.

    python tests/_torch_dist.py INPUTS.npz OUT_DIR

Rank r writes ``OUT_DIR/rank{r}.pt``: its mesh coordinates, its outputs
of each distributed case (its own slice), its aux values, the form
``moe_apply`` chose under ``REPRO_MOE_SHARDMAP``, the specs
``param_specs`` gives its smoke models and the placements ``constrain``
gives a DTensor.  Inputs come from the npz the test wrote with numpy.
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
