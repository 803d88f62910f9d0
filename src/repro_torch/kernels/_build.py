"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

The counterpart of ``repro/kernels/ops.py``: where the JAX package
picked interpret or compiled Pallas, the port compiles its hand-written
Hopper kernels with ``nvcc`` into one shared library with a plain C
interface and binds it with :mod:`ctypes`.  Nothing here includes
PyTorch's headers, so a build takes seconds, not minutes.

The library is built at first use into ``build/repro_torch/<key>/`` at
the repository root, where ``<key>`` hashes the sources and the flags:
an edited kernel gets a fresh build, an unchanged one is loaded as is.
Every source compiles in its own ``nvcc`` process, all started
together, and the objects are linked into ``libreprotorch.so``.

Each kernel wrapper counts its launches in :data:`launches` (a plain
integer per kernel) where it calls into the library, and nowhere else,
so a run can show that its main path went through the kernels; a
kernel with more than one body also counts each launch under its body
in :data:`bodies`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parents[1] / "build" / "repro_torch"
LIB_NAME = "libreprotorch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: kernel name -> launches since the last reset (see reset_launches)
launches: Dict[str, int] = {"rmsnorm": 0, "paged_decode_attention": 0,
                            "paged_prefill_attention": 0,
                            "paged_chunk_attention": 0,
                            "ring_chunk_attention": 0,
                            "flash_attention": 0,
                            "dense_decode_attention": 0,
                            "quant_matmul_int8": 0, "quant_matmul_int4": 0,
                            "selective_scan": 0,
                            "empty": 0}   # launch_floor.py's yardstick

#: kernel name -> body -> launches since the last reset, for the kernels
#: with more than one body (the body names of csrc/*.cu: "mma", the bf16
#: tensor-core body; "state_lanes", the scan with d_state split across
#: lanes; "add_norm" and "norm", rmsnorm with and without the residual
#: add, the row in registers; "cuda_core", the f32 CUDA-core body, the
#: previous one where a kernel was redesigned)
bodies: Dict[str, Dict[str, int]] = {
    **{name: {"mma": 0, "cuda_core": 0}
       for name in ("paged_decode_attention", "paged_prefill_attention",
                    "paged_chunk_attention", "ring_chunk_attention",
                    "flash_attention", "dense_decode_attention",
                    "quant_matmul_int8", "quant_matmul_int4")},
    "selective_scan": {"state_lanes": 0, "cuda_core": 0},
    "rmsnorm": {"add_norm": 0, "norm": 0, "cuda_core": 0}}
BODY_CODES = {"cuda_core": 0, "mma": 1, "state_lanes": 2,   # csrc/common.cuh
              "add_norm": 3, "norm": 4}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for counts in bodies.values():
        for body in counts:
            counts[body] = 0


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("repro_torch: nvcc not found (PATH, CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the library if this source hash has no build yet, and
    return its path.  Concurrent builds race harmlessly: each process
    builds in a private directory and the first rename wins."""
    global build_seconds
    out_dir = BUILD_ROOT / build_key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    t0 = time.perf_counter()
    nvcc = _nvcc()
    cus = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in cus:
        obj = tmp / (src.stem + ".o")
        log = open(tmp / (src.stem + ".log"), "w")
        procs.append((src, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
             "-o", str(obj)], stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(src.name)
    if failed:
        logs = "\n".join((tmp / (Path(f).stem + ".log")).read_text()
                         for f in failed)
        raise RuntimeError(f"nvcc failed on {failed}:\n{logs}")
    subprocess.run([nvcc, *NVCC_FLAGS[:4], "-shared", "-o", str(tmp / LIB_NAME),
                    *[str(tmp / (s.stem + ".o")) for s in cus]],
                   check=True, capture_output=True)
    build_seconds = time.perf_counter() - t0
    try:
        os.rename(tmp, out_dir)
    except OSError:            # another process finished first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def ptxas_report() -> str:
    """The compiler's per-kernel register / shared-memory report of the
    current build (``-Xptxas=-v`` output), for the chip smoke log."""
    out_dir = BUILD_ROOT / build_key()
    return "\n".join(p.read_text() for p in sorted(out_dir.glob("*.log")))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # x, delta, scale, r_out, out, rows, d, eps, dtype, body, vec, lanes,
    # rows per block, accesses a lane, stream
    "rt_rmsnorm": (_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I, _I,
                   _P),
    # q, k_pool, v_pool, tables, pos, out, B, H, KV, hd, bs, nb, scale,
    # dtype, body, splits, stream
    "rt_paged_decode_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _F, _I, _I, _I, _P),
    # q, k_pool, v_pool, table, out, C, H, KV, hd, bs, nb, pos, scale,
    # dtype, body, splits, stream
    "rt_paged_prefill_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _I, _I, _I, _P),
    # q, k_pool, v_pool, tables, pos (device), out, B, C, H, KV, hd, bs,
    # nb, scale, dtype, body, splits, stream
    "rt_paged_chunk_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _F, _I, _I, _I, _P),
    # q, k_pool, v_pool, table, k_new, v_new, pos (device, or null), out,
    # C, H, KV, hd, bs, nb, pos (host), w, scale, dtype, body, splits,
    # stream
    "rt_ring_chunk_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    # q, k, v, out, lse, B, H, KV, S, hd, the element strides of q, of
    # k and v, and of out (batch, head, position), causal, window, scale,
    # dtype, body, stream
    "rt_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L,
                           _L, _L, _L, _L, _L, _L, _L, _I, _I, _F, _I, _I,
                           _P),
    # q, k_cache, v_cache, pos, out, B, H, KV, hd, S, scale, dtype, body,
    # splits, stream
    "rt_dense_decode_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _F, _I, _I, _I, _P),
    # x, q, s, out, M, K, N, group (unused), dtype, body, splits, stream
    "rt_quant_matmul_int8": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _P),
    # x, q, s, out, M, K, N, group, dtype, body, splits, stream
    "rt_quant_matmul_int4": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _P),
    # dt, b_mat, c_mat, x, a_neg, h0, y, h_out, B, T, DI, DS, B/C batch
    # and time strides, body, lanes, stream
    "rt_selective_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _L, _L, _I, _I, _P),
    # blocks, threads, stream
    "rt_empty": (_I, _I, _P),
    # cluster size, threads, dynamic shared memory, out (int*)
    "rt_max_active_clusters": (_I, _I, _I, _P),
}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error (its return is
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh


def dtype_code(dtype) -> int:
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, "
                        f"not {dtype}") from None
