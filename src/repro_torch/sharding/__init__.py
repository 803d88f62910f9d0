"""Sharding rules of the port: logical names and parameter paths to
partition specs over a :class:`torch.distributed.device_mesh.DeviceMesh`
(``specs.py``)."""
from repro_torch.sharding.specs import (  # noqa: F401
    PartitionSpec, constrain, current_mesh, fit_spec, local_shard,
    param_spec, param_specs, sharding_rules, to_placements, use_mesh_rules)
