"""The empty kernel (``csrc/launch_floor.cu``): a yardstick for the
least time one launch takes on the card, timed beside the port's
kernels, and for how many clusters of blocks the card holds at once
(:func:`max_active_clusters`).  It replaces no TPU kernel and no model
path launches it.

Like every wrapper it counts its launches, and it launches only for a
CUDA device; on the CPU it does nothing, which is all its plain version
would do.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def empty(device: torch.device, blocks: int = 1, threads: int = 128) -> None:
    """Launch ``blocks`` blocks of ``threads`` threads that do nothing,
    on the current stream of ``device`` (nothing at all on the CPU)."""
    device = torch.device(device)
    if device.type == "cpu":
        return
    if device.type != "cuda":
        raise ValueError(f"empty: device {device}; the kernel needs a "
                         f"CUDA device")
    if blocks < 1 or not 1 <= threads <= 1024:
        raise ValueError(f"empty: {blocks} blocks of {threads} threads")
    lib = _build.library()
    _build.launches["empty"] += 1
    _build.check(lib.rt_empty(blocks, threads,
                              torch.cuda.current_stream(device).cuda_stream),
                 "empty")


def max_active_clusters(cluster: int, threads: int, smem: int) -> int:
    """Clusters of ``cluster`` blocks of ``threads`` threads, each with
    ``smem`` bytes of dynamic shared memory, that the card runs at once
    (``cudaOccupancyMaxActiveClusters``; nothing is launched)."""
    out = ctypes.c_int(0)
    _build.check(_build.library().rt_max_active_clusters(
        cluster, threads, smem, ctypes.byref(out)), "max_active_clusters")
    return out.value
