"""Multi-pod dry-run: one rank's partitioned step of every (arch x
shape) on the production meshes, with no device memory (the port of
``repro/launch/dryrun.py``).

The reference lowers and compiles each step for 256 or 512 TPU chips
and reads the compiled module's costs.  Here the step is the port's own
(``launch/steps.py::make_step``: the train step, a serving prefill or a
decode step), its inputs DTensors over a ``16x16`` (or ``2x16x16``)
mesh of a *fake* process group (``FakeStore``: every collective
returns at once, nothing leaves the process) whose locals are fake
tensors (:data:`DEVICE`), and the step runs once under
``launch/hlo_analysis.py::StepRecorder``, which counts what rank 0
does.  Each record has the reference's keys:

* ``flops``: one device's matrix-product FLOPs (``FlopCounterMode``'s
  formulas and the fake kernels'; XLA's count also holds elementwise
  work);
* ``hbm_bytes``: one device's bytes read and written by every operation,
  unfused (an upper bound against XLA's fused count);
* the collective row (``all-gather_bytes``, ... ``collective_bytes``),
  the three roofline terms and ``dominant``;
* ``argument_bytes`` (the rank's inputs), ``output_bytes`` (its
  outputs), ``temp_bytes`` (the most bytes the step had alive at once
  beyond its inputs) and ``peak_bytes`` = argument + temp;
* ``n_chips``, and ``compile_s``: the seconds the fake step took (there
  is no compile).

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun             # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k --mesh both --out results.jsonl
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

import torch

from repro_torch.config import SHAPES
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.hlo_analysis import StepRecorder, roofline_terms
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_step
from repro_torch.sharding.specs import use_mesh_rules

#: ranks of the fake process group: enough for the 2x16x16 mesh
WORLD = 512
#: the device type of the fake tensors.  Nothing is allocated on it and
#: every count is the same on either; "cuda" fails the train step under
#: torch 2.11's DTensor (a checkpoint's recompute saves other tensors
#: than its forward; a vocab-sharded reduction indexes a 2-d tensor with
#: a 3-d mask), and a CPU-only torch refuses autograd of a CUDA tensor
#: even a fake one, so the dry-run's tensors are the CPU's
DEVICE = "cpu"


def fake_world(world: int = WORLD) -> None:
    """Start a fake process group of ``world`` ranks in this process
    (rank 0), unless one is already up.  Nothing is sent anywhere."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() < world:
            raise RuntimeError(f"dry-run: a process group of "
                               f"{dist.get_world_size()} ranks is up; "
                               f"the dry-run needs {world} fake ranks")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


_MESHES: dict = {}


def production_mesh(multi_pod: bool):
    """The production mesh over the fake world (on :data:`DEVICE`), made
    once a process (each DeviceMesh makes its process groups)."""
    if multi_pod not in _MESHES:
        fake_world()
        _MESHES[multi_pod] = make_production_mesh(multi_pod=multi_pod,
                                                  device=DEVICE)
    return _MESHES[multi_pod]


def _bytes(tree) -> int:
    """Local bytes of the DTensor / tensor leaves of ``tree``, each
    storage once."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor):
            continue
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def run_step(fn, args) -> tuple:
    """(output, recorder) of one run of a ``make_step`` step."""
    with StepRecorder() as rec:
        out = fn(*args)
    return out, rec


def measure(cfg, shape, mesh, decode_cache_layout: str = "heads") -> dict:
    """One run of ``make_step(cfg, shape, mesh)`` under
    :class:`StepRecorder`: the record's measured keys (all but the
    cell's names and ``compile_s``).  The caller has the fake world up
    (:func:`fake_world`)."""
    with use_mesh_rules(mesh):
        fn, args = make_step(cfg, shape, mesh,
                             decode_cache_layout=decode_cache_layout)
        out, stats = run_step(fn, args)
    flops, hbm = float(stats.flops), float(stats.hbm_bytes)
    coll = stats.collectives
    args_b = _bytes(args)
    return {**coll.row(),
            **roofline_terms(flops, hbm, coll.total_bytes, mesh.size()),
            "status": "ok", "flops": flops, "hbm_bytes": hbm,
            "n_chips": mesh.size(), "argument_bytes": args_b,
            "output_bytes": _bytes(out), "temp_bytes": stats.temp_peak,
            "peak_bytes": args_b + stats.temp_peak}


def dryrun_one(arch: str, shape_name: str, multi_pod: bool,
               decode_cache_layout: str = "heads",
               verbose: bool = True) -> dict:
    """One cell's record."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "layout": decode_cache_layout}
    if not cfg.supports_shape(shape):
        rec["status"] = "skipped(DESIGN.md rule)"
        return rec
    t0 = time.time()
    try:
        mesh = production_mesh(multi_pod)
        rec.update(measure(cfg, shape, mesh, decode_cache_layout))
        rec["compile_s"] = round(time.time() - t0, 1)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']} "
                  f"({decode_cache_layout}): OK "
                  f"flops={rec['flops']:.3e} hbm={rec['hbm_bytes']:.3e} "
                  f"coll={rec['collective_bytes']:.3e} "
                  f"dom={rec['dominant']} {rec['compile_s']}s", flush=True)
            print(f"  memory: args={rec['argument_bytes']:.3e} "
                  f"temp={rec['temp_bytes']:.3e} "
                  f"out={rec['output_bytes']:.3e}", flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue
        rec["status"] = f"FAIL: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: "
                  f"FAILED {type(e).__name__}: {str(e)[:300]}", flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--layout", default="heads", choices=["heads", "seq"])
    ap.add_argument("--out", default=None, help="append JSONL results here")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                rec = dryrun_one(arch, shape, multi,
                                 decode_cache_layout=args.layout)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                if str(rec.get("status", "")).startswith("FAIL"):
                    n_fail += 1
    print(f"[dryrun] done, {n_fail} failures", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
