"""What one partitioned step costs a device: FLOPs, bytes, collectives,
memory, and the roofline terms of those.

The port of ``repro/launch/hlo_analysis.py``.  The reference reads them
from a compiled XLA module (``cost_analysis()``, ``memory_analysis()``
and the collective instructions of its HLO text); the port has no HLO,
so :class:`StepRecorder` counts them while the step runs on fake tensors
as DTensors over a fake process group (``launch/dryrun.py``).  It is a
``TorchDispatchMode`` that sees the *local* operations of one rank
(rank 0; every rank runs the same shapes):

* ``flops``: the matrix-product FLOPs of ``torch.utils.flop_counter``'s
  formulas (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, SDPA)
  and of the fake kernels' (``kernels/fake.py``).  XLA's count also holds
  elementwise work, so the reference's number is larger by that.
* ``hbm_bytes``: the bytes every operation reads (its tensor inputs)
  and writes (its outputs), each operation on its own: an upper bound
  against XLA's count, which fuses elementwise chains and so reads and
  writes their intermediates never.  Views and allocations move nothing.
* the collectives: each ``_c10d_functional`` op DTensor issues (once;
  not again at its ``wait_tensor``) and each ``c10d`` op an explicit form
  issues (``dist.all_reduce`` of the MoE and flash-decode forms), by the
  bytes of its *result* on this device, as the reference's parser sums
  each instruction's result shape (:class:`CollectiveStats`).
* memory: the bytes of every storage an operation creates, alive from
  then until the storage is freed; ``temp_peak`` is the most alive at
  once.

The shape propagation DTensor runs on global-shaped fake tensors to
plan an operation is not the rank's work and is not counted.

:func:`roofline_terms`, :func:`mfu` and :func:`mbu` are the reference's
with the H100's spec-sheet peaks in place of the TPU's.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: op name -> the reference's collective kind (functional ops DTensor
#: issues, then the c10d ops of explicit ``torch.distributed`` calls)
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    # a permute sends one buffer and receives one: counted at its send
    "send": "collective-permute",
    "isend": "collective-permute",
}

#: operations that allocate without writing, or move nothing
_NO_TRAFFIC = frozenset({
    "empty", "empty_strided", "new_empty", "new_empty_strided",
    "empty_like", "_unsafe_view", "detach", "alias", "lift_fresh",
    "wait_tensor", "device", "dim", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size", "_local_scalar_dense",
})


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1

    def row(self) -> dict:
        out = {}
        for k in _COLLECTIVES:
            out[f"{k}_bytes"] = self.bytes_by_kind.get(k, 0)
            out[f"{k}_count"] = self.count_by_kind.get(k, 0)
        out["collective_bytes"] = self.total_bytes
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors of an op's (nested) args or outputs."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


_planning = threading.local()


@contextlib.contextmanager
def _skip_dtensor_planning():
    """Mark the operations DTensor runs on global-shaped fake tensors to
    derive an operation's output metadata, so that
    :class:`StepRecorder` leaves them out."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:          # no DTensor: nothing to leave out
        yield
        return
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        raise RuntimeError("StepRecorder: this torch's DTensor has no "
                           f"ShardingPropagator.{name}; the recorder "
                           "cannot tell planning from a rank's work")

    def planned(self, *args, **kwargs):
        _planning.depth = getattr(_planning, "depth", 0) + 1
        try:
            with torch.no_grad():     # planning records no gradient
                return orig(self, *args, **kwargs)
        finally:
            _planning.depth -= 1

    setattr(ShardingPropagator, name, planned)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


class StepRecorder(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes, collectives and live memory while
    it is entered (see the module docstring).  ``with StepRecorder() as
    rec: step(...)``, then read ``rec.flops``, ``rec.hbm_bytes``,
    ``rec.collectives`` (:class:`CollectiveStats`) and ``rec.temp_peak``
    (bytes)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0
        self.hbm_bytes = 0
        self.collectives = CollectiveStats()
        self.live = 0
        self.temp_peak = 0
        self._seen = set()
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(_skip_dtensor_planning())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def _track(self, out, inputs) -> None:
        """Count the storages ``out`` holds that no input holds, alive
        until each is freed."""
        held = {t.untyped_storage()._cdata for t in inputs}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in held or key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            self.temp_peak = max(self.temp_peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented    # DTensor runs the rank's local ops
        out = func(*args, **kwargs)
        if getattr(_planning, "depth", 0):
            return out
        packet = func._overloadpacket
        name = packet.__name__
        inputs = _tensors((args, kwargs))
        kind = COLLECTIVE_KINDS.get(name)
        if kind is not None:
            res = _tensors(out) or inputs[:1]
            self.collectives.add(kind, sum(_nbytes(t) for t in res))
            self._track(out, inputs)
            return out
        if packet in self.flop_registry:
            self.flops += self.flop_registry[packet](*args, **kwargs,
                                                     out_val=out)
        if name not in _NO_TRAFFIC and not func.is_view:
            self.hbm_bytes += (sum(_nbytes(t) for t in inputs)
                               + sum(_nbytes(t) for t in _tensors(out)))
        if not func.is_view:
            self._track(out, inputs)
        return out


# ----------------------------------------------------------------------
# Roofline terms
# ----------------------------------------------------------------------
# NVIDIA H100 SXM5 80GB, per card, from NVIDIA's spec sheet (not
# measured here): dense bf16 tensor-core peak, HBM3 bandwidth, and
# NVLink 4 bandwidth in one direction (900 GB/s both ways).  A card may
# be capped below its 700 W; ``nvidia-smi --query-gpu=name,power.limit``
# names the card and its limit beside any number read against these.
PEAK_FLOPS_BF16 = 989.4e12    # FLOP/s
HBM_BW = 3.35e12              # B/s
NVLINK_BW = 450e9             # B/s, one direction


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   n_chips: int) -> dict:
    """The three roofline times (seconds).

    Every count of :class:`StepRecorder` is one device's, so none of
    the terms divides by ``n_chips``.  (A ring all-gather moves
    (n-1)/n x bytes per link; the x1 upper bound is used.)"""
    del n_chips
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = hbm_bytes / HBM_BW
    t_collective = coll_bytes / NVLINK_BW
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)), key=lambda kv: kv[1])[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
    }


def mfu(flops_per_token: float, tok_per_s: float) -> float:
    """Model FLOPs Utilization: useful model FLOP/s as a fraction of one
    card's ``PEAK_FLOPS_BF16``.  ``flops_per_token`` is the *model*
    count (2 x active params for inference, 6 x for training), not the
    step's count, so rematerialization and padding are left out."""
    return flops_per_token * tok_per_s / PEAK_FLOPS_BF16


def mbu(bytes_per_token: float, tok_per_s: float) -> float:
    """Model Bandwidth Utilization: the bytes a decode step must stream
    per generated token (weights once a step, plus the KV cache) times
    tokens/s, as a fraction of one card's ``HBM_BW``."""
    return bytes_per_token * tok_per_s / HBM_BW
