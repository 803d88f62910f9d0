"""Bridge: real model configs -> the paper's microservice abstraction.

A transformer serving pipeline decomposes into
  light: tokenize -> [core stages...] -> light: sample -> light: detokenize
with core MSs = contiguous layer ranges (plus expert groups for MoE and
the encoder for enc-dec).  Profiles (a_m, b_m, r_m) derive from FLOPs and
activation/param bytes, so the paper's placement machinery operates on
*real* numbers; `profile_stage_ms` measures a stage's time: CUDA events
for a call whose output lies on the card, the host clock on the CPU.

The port's copy of ``repro/microservice/partition.py``; only
``profile_stage_ms`` differs (the reference blocks on a jitted call).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.core import paper_params as pp
from repro_torch.core.graph import Application, Microservice, TaskType


@dataclass
class StageSpec:
    name: str
    kind: str            # "core" | "light"
    layer_range: tuple | None
    flops_per_token: float
    param_bytes: int
    act_bytes_out: int   # activation bytes shipped to the next stage


def decompose(cfg, n_core_stages: int = 2, tokens_per_req: int = 64,
              bytes_per_param: float = 2.0) -> List[StageSpec]:
    """``bytes_per_param`` sets the resident weight bytes per parameter
    for the core stages' `param_bytes` (2.0 = bf16 dense; weight-only
    quantization passes models.quantize.bytes_per_param(fmt), shrinking
    the service memory footprint the placement IP sees).  FLOPs are
    unchanged — dequant happens inside the matmul."""
    d = cfg.d_model
    stages: List[StageSpec] = [
        StageSpec("tokenize", "light", None, 1e3, 1 << 20, tokens_per_req * 4),
    ]
    if cfg.is_encoder_decoder:
        enc_flops = (cfg.n_encoder_layers
                     * cfg.layer_params("attn") * 2)
        stages.append(StageSpec(
            "encoder", "core", (0, cfg.n_encoder_layers), enc_flops,
            int(cfg.n_encoder_layers * cfg.layer_params("attn")
                * bytes_per_param),
            cfg.encoder_seq * d * 2))
    per = cfg.n_layers // n_core_stages
    for i in range(n_core_stages):
        lo = i * per
        hi = cfg.n_layers if i == n_core_stages - 1 else (i + 1) * per
        flops = sum(cfg.layer_active_params(cfg.block_pattern[j]) * 2
                    for j in range(lo, hi))
        pbytes = int(sum(cfg.layer_params(cfg.block_pattern[j])
                         * bytes_per_param for j in range(lo, hi)))
        stages.append(StageSpec(f"stage{i}", "core", (lo, hi),
                                flops, pbytes, d * 2))
    stages.append(StageSpec("sample", "light", None,
                            cfg.vocab_size * 4.0, 1 << 20, 4))
    stages.append(StageSpec("detokenize", "light", None, 1e3, 1 << 20,
                            tokens_per_req * 4))
    return stages


def to_application(cfg, stages: List[StageSpec],
                   rng: np.random.Generator,
                   measured_ms: dict | None = None,
                   deadline_ms: float = 80.0,
                   rate: float = 0.5) -> Application:
    """Build a core.graph.Application whose single task type is this
    model's serving pipeline.  Workloads a_m are expressed in MB with
    rates f in MB/ms such that a/f equals the (measured or estimated)
    stage latency."""
    services = []
    light_spec = pp.TABLE_I["light_ms"]
    for i, st in enumerate(stages):
        est_ms = (measured_ms or {}).get(
            st.name, max(st.flops_per_token / 5e9, 0.05))
        a_mb = max(st.act_bytes_out / 1e6, 0.05)
        if st.kind == "core":
            # deterministic rate calibrated to the stage latency
            services.append(Microservice(
                idx=i, name=st.name, kind="core",
                r=np.array([4.0, st.param_bytes / 1e9,
                            8.0, st.param_bytes / 1e9]),
                a=a_mb, b=a_mb, f_det=a_mb / est_ms,
                c_dp=pp.TABLE_I["core_ms"]["c_dp"],
                c_mt=pp.TABLE_I["core_ms"]["c_mt"]))
        else:
            # stochastic: Gamma with mean matching the measurement
            shape = float(rng.uniform(*light_spec["f_gamma_shape"]))
            scale = (a_mb / est_ms) / shape
            services.append(Microservice(
                idx=i, name=st.name, kind="light",
                r=np.array([0.5, 0.1, 0.25, 0.1]),
                a=a_mb, b=a_mb, f_shape=shape, f_scale=scale,
                c_dp=light_spec["c_dp"], c_mt=light_spec["c_mt"],
                c_pl=light_spec["c_pl"]))
    ids = list(range(len(services)))
    tt = TaskType(idx=0, name=f"serve-{cfg.name}", ms_ids=ids,
                  edges=[(ids[i], ids[i + 1]) for i in range(len(ids) - 1)],
                  deadline=deadline_ms,
                  payload=0.01, rate=rate)
    return Application(services=services, task_types=[tt])


def _first_tensor(out):
    """The first tensor of a call's output (a tensor, or nested tuples
    of them, as a pipeline stage's ``(x, delta)``), None if none."""
    if isinstance(out, tuple):
        return next((t for t in map(_first_tensor, out) if t is not None),
                    None)
    return out if isinstance(out, torch.Tensor) else None


def profile_stage_ms(fn, *args, iters: int = 3) -> float:
    """Median time of ``fn(*args)`` over ``iters`` calls after one warm
    call (ms).  When the output lies on the card each call is timed by a
    pair of CUDA events on the current stream (device time from the
    first launch to the last); on the CPU by ``time.perf_counter``."""
    out = fn(*args)
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
        ts = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        return float(np.median(ts))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))
