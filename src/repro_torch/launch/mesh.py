"""Meshes of the port (the counterpart of ``repro/launch/mesh.py``).

:func:`make_production_mesh` is a function, not a module constant, so
importing this module never touches the process group.  One pod is
16x16 = 256 ranks ``("data", "model")``; two pods 2x16x16 = 512 with a
leading ``"pod"`` axis.  Rank r sits at the row-major coordinate of r.
The caller starts the ranks and their process group
(``torch.distributed.init_process_group`` with an address, a world size
and a rank: nothing tells a program of a cluster);
:func:`make_host_mesh` makes the one-rank world itself where none
exists.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """The mesh over the world's first 16x16 (or 2x16x16) ranks, as the
    reference takes the first devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have} — start "
            f"{n} ranks and their process group "
            "(torch.distributed.init_process_group) first")
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(device: str = "cuda") -> DeviceMesh:
    """Trivial 1x1 ``("data", "model")`` mesh over rank 0's device (the
    reference's ``jax.devices()[:1]``).  With no process group yet, it
    starts a world of one (gloo, through an in-memory store)."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return DeviceMesh(device, torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))
