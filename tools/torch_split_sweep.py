#!/usr/bin/env python3
"""Time the port's split kernels at every split count, on the card.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 tools/torch_split_sweep.py [--quant | --cross | --chunk | --mma]

For the int8 and int4 quant matmuls' ``wgmma`` body (the rule's body in
bf16, ``csrc/quant_wgmma.cu``) at every projection site of smollm-360m
(wq / wo 960 -> 960, wk / wv 960 -> 320, w_gate / w_up 960 -> 2560,
w_down 2560 -> 960) and qwen2-72b (wq / wo 8192 -> 8192, wk / wv 8192 ->
1024, w_gate / w_up 8192 -> 29568, w_down 29568 -> 8192; weights drawn
on the card) at M 8 (decode) and 128 (a prefill chunk), it times every
split count ``wgmma_splits`` may take (1 to 8 slices of whole stages)
beside the count it picks; at those M, at M 16 and, at smollm-360m's
sites, at M 32 and 64 too, it times the ``wgmma`` body at its rule's
split against the ``mma`` body at its own rule's split in turns
(``wgmma``, ``mma``, ``mma``, ``wgmma``), and at M 8 and 16 against the
body's variants (``QMM_VARIANTS``: the library built again with
``csrc/quant_wgmma.cu``'s macros set, e.g. one CTA an SM at n8 / n16
where the body runs two), one JSON line a site, format and M
(``QMM_SITES``).  ``--quant`` stops there.  Without it, for the split
decode attention at 1, 4 and 8 rows of smollm-360m and at gemma3-12b's 8 rows of hd 256 (linear rows of 2176 slots and rings of
1024, the wide layout), for the paged prefill's wide body at
gemma3-12b's chunk (C 128 at pos 0, 512, 1024 and 2048) and for the
window form's (``ring_chunk_attention``: C 128 over a ring of w = 1024
slots at pos 0, 512 and 3000), it forces each
split count in turn (through the wrappers' split rules) and prints one
JSON line per shape: the device time per call in ms for each count
(torch.profiler, as ``chip_smoke.py`` measures kernels; the median of
three at hd 256) beside the count the rule picks.  Before the hd-256
rows it prints how many clusters of each size the card holds at once at
the wide bodies' shared memory, the table the wide split rule reads
(``decode_attention.WIDE_CLUSTERS``).  The first line is the card's name and power limit.
With ``--cross`` it times only the cross form's ``wgmma`` body
(``paged_cross_attention``, C 128) at every split count its cluster may
take, at seamless-m4t-medium's (16 / 16 heads of 64 over 1024 frames)
and llama-3.2-vision-90b's (64 / 8 heads of 128 over 1601 patches)
shapes, B 1 and 8, over blocks of 16 and over dense rows through
identity tables, beside the count ``cross_splits`` picks.
With ``--mma`` it times only the quant matmuls' previous ``mma`` body
at every split count at smollm-360m's shapes (``QMM_SHAPES``), beside
``quant_splits``' pick.
With ``--chunk`` it times only serving's chunk forms on their ``wgmma``
body (``csrc/chunk_wgmma.cu``): the one-row paged chunk (C 128, blocks
of 16) at smollm-360m's (15 / 5 heads of 64, 1024 slots),
zamba2-7b's (32 / 32 of 112, 2176), the hd-128 G-8 chunk (64 / 8 of
128, 1152) and seamless-m4t-medium's decoder (16 / 16 of 64, 1024)
shapes at each pos, every split count beside the count ``chunk_splits``
picks and the ``mma`` body; the same shapes' shorter chunks (C 1 to 64
at pos 512) and the verify round (B 8, C 5, smollm-360m's and
qwen2-72b's heads, pos 32-600 on the device) at every split count and
on both bodies in turns (``wgmma``, ``mma``, ``mma``, ``wgmma``); and
the window form at mixtral-8x7b's shape (C 128, 32 / 8 heads of 128,
w 4096) at pos 0, 2048 and 4300, every split count beside
``ring_splits``' and ``mma``.
Without a CUDA device it exits with code 2.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

QMM_SHAPES = [(8, 960, 2560), (8, 960, 960), (8, 960, 320), (8, 2560, 960),
              (128, 2560, 960), (128, 960, 2560), (128, 960, 960),
              (128, 960, 320)]
#: the quant matmul's sites (model, K, N) the wgmma sweep times at M 8
#: and 128
QMM_SITES = [("smollm-360m", 960, 960), ("smollm-360m", 960, 320),
             ("smollm-360m", 960, 2560), ("smollm-360m", 2560, 960),
             ("qwen2-72b", 8192, 8192), ("qwen2-72b", 8192, 1024),
             ("qwen2-72b", 8192, 29568), ("qwen2-72b", 29568, 8192)]


#: rows of x the wgmma and mma bodies are also timed at, in turns, at
#: smollm-360m's sites (the serve runs' ragged chunks and decode batches)
QMM_MID_ROWS = (16, 32, 64)
#: variants of the quant wgmma body (``--quant``): the macros of
#: csrc/quant_wgmma.cu each sets, and the rows of x it is timed at
QMM_VARIANTS = {"one_cta_an_sm": (("-DRT_QW_SMALL_CTAS=1",), (8, 16))}


def variant_library(build, name: str, defines):
    """This tree's kernel library compiled with ``defines`` (every
    source at once, as ``_build.build`` does) into a directory of its own
    under the build directory, loaded with the entries' signatures."""
    import ctypes
    out = build.BUILD_ROOT / "variant" / name
    out.mkdir(parents=True, exist_ok=True)
    procs = [(src, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, *defines, "-I", str(build.CSRC),
         "-c", str(src), "-o", str(out / (src.stem + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in sorted(build.CSRC.glob("*.cu"))]
    for src, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({name}):\n{log}")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS[:4], "-shared", "-o",
                    str(out / build.LIB_NAME),
                    *[str(out / (src.stem + ".o")) for src, _ in procs]],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / build.LIB_NAME))
    for entry, argtypes in build._SIGNATURES.items():
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def _on(build, lib, fn):
    """``fn`` run with the wrappers launching from ``lib``."""
    def run():
        tree = build._lib
        build._lib = lib
        try:
            return fn()
        finally:
            build._lib = tree
    return run


def quant_rows(dev) -> None:
    """The quant matmul's wgmma body at every split count, against the
    mma body and its variants (see the module docstring)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models.quantize import quantize_int4, quantize_int8
    variants = {name: (variant_library(_build, name, defines), rows)
                for name, (defines, rows) in QMM_VARIANTS.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    for model, k, n in QMM_SITES:
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        for fmt, pack, fn in (("int8", quantize_int8, qm.quant_matmul_int8),
                              ("int4", quantize_int4, qm.quant_matmul_int4)):
            packed = pack(w)
            q, s = packed["q"], packed["s"]
            rows_m = (8, 16, 32, 64, 128) if model == "smollm-360m" else (
                8, 16, 128)
            for m in rows_m:
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                stages = -(-k // qm.WGMMA_STAGE_K)
                counts = [sp for sp in range(1, min(8, stages) + 1)
                          if (sp - 1) * -(-stages // sp) < stages]
                bodies = {"wgmma": lambda: fn(x, q, s, _body="wgmma"),
                          "mma": lambda: fn(x, q, s, _body="mma")}
                for name, (lib, at) in variants.items():
                    if m in at:
                        bodies[name] = _on(_build, lib, bodies["wgmma"])
                row = {"kernel": f"quant_matmul_{fmt}", "model": model,
                       "shape": [m, k, n], "rows": qm.wgmma_rows(fmt, m),
                       "rule": qm.wgmma_splits(fmt, m, k, n),
                       "mma_rule": qm.quant_splits(m, k, n)}
                if m in (8, 128):
                    row["ms"] = _split_ms(qm, "wgmma_splits",
                                          bodies["wgmma"], counts)
                print(json.dumps({**row, **_turns(bodies)}), flush=True)
            del packed, q, s
        del w
        torch.cuda.empty_cache()


def cross_rows(dev, rng) -> None:
    """The cross form's wgmma body at every split count (see the module
    docstring)."""
    import torch
    from chip_smoke import device_ms
    from repro_torch.kernels import flash_attention as fa
    rule = fa.cross_splits
    c, bs = 128, 16
    for h, kv, hd, src in ((16, 16, 64, 1024), (64, 8, 128, 1601)):
        nb = -(-src // bs)
        nt = -(-src // fa.wgmma_tile_keys(hd, "cross"))
        for b in (1, 8):
            nbp = b * nb + 1
            kp = torch.randn(nbp, bs, kv, hd, device=dev, dtype=torch.bfloat16)
            vp = torch.randn_like(kp)
            tables = torch.from_numpy((rng.permutation(nbp - 1).reshape(
                b, nb) + 1).astype(np.int32)).to(dev)
            kd = kp[tables.long()].reshape(b, nb * bs, kv, hd)[:, :src]
            vd = vp[tables.long()].reshape(b, nb * bs, kv, hd)[:, :src]
            kd, vd = kd.contiguous(), vd.contiguous()
            ident = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
            q = torch.randn(b, c, h, hd, device=dev, dtype=torch.bfloat16)
            for layout, args in (("blocks of 16", (q, kp, vp, tables, src)),
                                 ("dense", (q, kd, vd, ident, src))):
                row = {"kernel": "paged_cross_attention", "B": b, "C": c,
                       "H": h, "KV": kv, "hd": hd, "src": src,
                       "layout": layout, "rule": rule(c, h, kv, hd, src),
                       "ms": {}}
                for sp in range(1, min(8, nt) + 1):
                    fa.cross_splits = lambda *a, sp=sp: sp
                    row["ms"][sp] = device_ms(
                        lambda: fa.paged_cross_attention(*args))
                fa.cross_splits = rule
                print(json.dumps(row), flush=True)


def _turns(fns: dict) -> dict:
    """Device ms of each callable, taken in turns forward and back; the
    mean of its two."""
    from chip_smoke import device_ms
    names = list(fns)
    got = {k: [] for k in names}
    for order in (names, names[::-1]):
        for k in order:
            got[k].append(device_ms(fns[k]))
    return {k: sum(v) / 2 for k, v in got.items()}


def _split_ms(module, rule_name: str, fn, counts) -> dict:
    """Device ms of ``fn`` with ``module.<rule_name>`` forced to each
    split count in turn (the rule restored after)."""
    from chip_smoke import device_ms
    rule = getattr(module, rule_name)
    out = {}
    try:
        for sp in counts:
            setattr(module, rule_name, lambda *a, sp=sp: sp)
            out[sp] = device_ms(fn)
    finally:
        setattr(module, rule_name, rule)
    return out


def chunk_rows(dev, rng) -> None:
    """The chunk forms' wgmma body at every split count (see the module
    docstring)."""
    import torch
    from chip_smoke import MIXTRAL, VERIFY_HEADS, VERIFY_POS
    from repro_torch.kernels import flash_attention as fa
    bf, bs = torch.bfloat16, 16

    def pools(n_blocks, kv, hd):
        kp = torch.randn(n_blocks + 1, bs, kv, hd, device=dev, dtype=bf)
        return kp, torch.randn_like(kp)

    for model, (h, kv, hd, cap, poss) in {
            "smollm-360m": (15, 5, 64, 1024, (0, 256, 896)),
            "zamba2-7b": (32, 32, 112, 2176, (0, 1024, 2048)),
            "hd-128 G-8": (64, 8, 128, 1152, (0, 1024)),
            "seamless-m4t-medium": (16, 16, 64, 1024, (0, 512))}.items():
        nb = cap // bs
        kp, vp = pools(nb, kv, hd)
        table = torch.from_numpy((rng.permutation(nb) + 1).astype(
            np.int32)).to(dev)
        q = torch.randn(128, h, hd, device=dev, dtype=bf)
        for p0 in poss:
            def one(body=None, p0=p0):
                return fa.paged_prefill_attention(q, kp, vp, table, p0,
                                                  _body=body)
            print(json.dumps({
                "kernel": "paged_prefill_attention", "model": model,
                "C": 128, "H": h, "KV": kv, "hd": hd, "pos": p0,
                "rule": fa.chunk_splits(128, h, kv, hd, cap),
                "ms": _split_ms(fa, "chunk_splits", lambda: one("wgmma"),
                                range(1, 9)),
                **_turns({"wgmma": lambda: one("wgmma"),
                          "mma": lambda: one("mma")})}), flush=True)
        for c in (1, 2, 5, 8, 16, 32, 64):
            qc = q[:c].contiguous()

            def short(body, qc=qc):
                return fa.paged_prefill_attention(qc, kp, vp, table, 512,
                                                  _body=body)
            print(json.dumps({
                "kernel": "paged_prefill_attention", "model": model, "C": c,
                "hd": hd, "pos": 512,
                "rule": fa.chunk_splits(c, h, kv, hd, cap),
                "ms": _split_ms(fa, "chunk_splits",
                                lambda: short("wgmma"), (1, 2, 4)),
                **_turns({"wgmma": lambda: short("wgmma"),
                          "mma": lambda: short("mma")})}), flush=True)
    b, c, s = 8, 5, 1024
    pos = torch.tensor(VERIFY_POS, dtype=torch.int32, device=dev)
    for model, (h, kv, hd) in VERIFY_HEADS.items():
        nb = s // bs
        kp, vp = pools(b * nb, kv, hd)
        tables = torch.from_numpy((rng.permutation(b * nb).reshape(
            b, nb) + 1).astype(np.int32)).to(dev)
        q = torch.randn(b, c, h, hd, device=dev, dtype=bf)

        def batched(body=None):
            return fa.paged_chunk_attention(q, kp, vp, tables, pos,
                                            _body=body)
        print(json.dumps({
            "kernel": "paged_chunk_attention", "model": model, "B": b,
            "C": c, "H": h, "KV": kv, "hd": hd,
            "rule": fa.chunk_splits(c, h, kv, hd, s),
            "ms": _split_ms(fa, "chunk_splits", lambda: batched("wgmma"),
                            range(1, 9)),
            **_turns({"wgmma": lambda: batched("wgmma"),
                      "mma": lambda: batched("mma")})}), flush=True)
    h, kv, hd, w, c = (MIXTRAL[k] for k in ("H", "KV", "hd", "w", "C"))
    nb = w // bs
    kp, vp = pools(nb, kv, hd)
    table = torch.from_numpy((rng.permutation(nb) + 1).astype(
        np.int32)).to(dev)
    q = torch.randn(c, h, hd, device=dev, dtype=bf)
    kn = torch.randn(c, kv, hd, device=dev, dtype=bf)
    vn = torch.randn_like(kn)
    for p0 in (0, 2048, 4300):
        def ring(body=None, p0=p0):
            return fa.ring_chunk_attention(q, kp, vp, table, kn, vn, p0, w,
                                           _body=body)
        print(json.dumps({
            "kernel": "ring_chunk_attention", "model": "mixtral-8x7b",
            "C": c, "H": h, "KV": kv, "hd": hd, "w": w, "pos": p0,
            "rule": fa.ring_splits(c, h, kv, hd, w, "wgmma"),
            "ms": _split_ms(fa, "ring_splits", lambda: ring("wgmma"),
                            range(1, 9)),
            **_turns({"wgmma": lambda: ring("wgmma"),
                      "mma": lambda: ring("mma")})}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_split_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from chip_smoke import device_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.launch_floor import max_active_clusters
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models.quantize import quantize_int4, quantize_int8

    def median_ms(fn):
        """The median of three device times: the hd-256 rows' split
        counts differ by less than calls to the card vary."""
        return sorted(device_ms(fn) for _ in range(3))[1]

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    _build.library()
    rng = np.random.default_rng(0)
    if sys.argv[1:] == ["--cross"]:
        cross_rows(dev, rng)
        return 0
    if sys.argv[1:] == ["--chunk"]:
        chunk_rows(dev, rng)
        return 0
    if sys.argv[1:] == ["--quant"]:
        quant_rows(dev)
        return 0
    if sys.argv[1:] != ["--mma"]:
        quant_rows(dev)
    qmm_rule = qm.quant_splits
    for m, k, n in (QMM_SHAPES if sys.argv[1:] == ["--mma"] else ()):
        w = torch.from_numpy(
            rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5)
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(
            np.float32)).to(dev, torch.bfloat16)
        for fmt, pack, fn in (("int8", quantize_int8, qm.quant_matmul_int8),
                              ("int4", quantize_int4, qm.quant_matmul_int4)):
            packed = pack(w)
            q, s = packed["q"].to(dev), packed["s"].to(dev)
            row = {"kernel": f"quant_matmul_{fmt}", "shape": [m, k, n],
                   "rule": qmm_rule(m, k, n), "ms": {}}
            for sp in range(1, min(8, -(-k // 64)) + 1):
                qm.quant_splits = lambda *a, sp=sp: sp
                row["ms"][sp] = device_ms(lambda: fn(x, q, s, _body="mma"))
            qm.quant_splits = qmm_rule
            print(json.dumps(row), flush=True)
    if sys.argv[1:] == ["--mma"]:
        return 0

    h, kv, hd, bs, nb = 15, 5, 64, 16, 64          # smollm-360m's pool
    decode_rule = da.decode_splits
    for b in (8, 4, 1):
        nbp = b * nb + 1
        kp = torch.randn(nbp, bs, kv, hd, device=dev, dtype=torch.bfloat16)
        vp = torch.randn_like(kp)
        tables = torch.from_numpy((rng.permutation(nbp - 1)[:b * nb].reshape(
            b, nb) + 1).astype(np.int32)).to(dev)
        pos = torch.from_numpy(rng.integers(64, 640, size=b).astype(
            np.int32)).to(dev)
        q = torch.randn(b, h, hd, device=dev, dtype=torch.bfloat16)
        row = {"kernel": "paged_decode_attention", "B": b,
               "rule": decode_rule(b, kv, nb * bs, hd), "ms": {}}
        for sp in range(1, 9):
            da.decode_splits = lambda *a, sp=sp: sp
            row["ms"][sp] = device_ms(
                lambda: da.paged_decode_attention(q, kp, vp, tables, pos))
        da.decode_splits = decode_rule
        print(json.dumps(row), flush=True)

    # how many clusters of each size the card holds at once at the wide
    # bodies' shared memory (one block an SM): the prefill's (the window
    # form takes the same tiles) and the decode's
    for name, threads, smem in (
            ("paged_prefill_attention", 256, fa.prefill_smem_bytes(256)),
            ("ring_chunk_attention", 256, fa.prefill_smem_bytes(256)),
            ("paged_decode_attention", 128, da.decode_smem_bytes(256, 2))):
        print(json.dumps({"occupancy": name, "threads": threads,
                          "smem": smem, "max_active_clusters": {
                              sp: max_active_clusters(sp, threads, smem)
                              for sp in range(1, 9)}}), flush=True)

    # gemma3-12b: 16 heads over 8 KV heads of 256, blocks of 16
    h, kv, hd, bs, b = 16, 8, 256, 16, 8
    decode_pos = np.array([5, 300, 1022, 1023, 1024, 1500, 1777, 2000])
    for slots in (2176, 1024):
        nb = slots // bs
        nbp = b * nb + 1
        kp = torch.randn(nbp, bs, kv, hd, device=dev, dtype=torch.bfloat16)
        vp = torch.randn_like(kp)
        tables = torch.from_numpy((rng.permutation(nbp - 1).reshape(
            b, nb) + 1).astype(np.int32)).to(dev)
        pos = torch.from_numpy(np.minimum(decode_pos, slots - 1).astype(
            np.int32)).to(dev)
        q = torch.randn(b, h, hd, device=dev, dtype=torch.bfloat16)
        row = {"kernel": "paged_decode_attention", "B": b, "hd": hd,
               "slots": slots, "rule": decode_rule(b, kv, slots, hd),
               "ms": {}}
        for sp in range(1, 9):
            da.decode_splits = lambda *a, sp=sp: sp
            row["ms"][sp] = median_ms(
                lambda: da.paged_decode_attention(q, kp, vp, tables, pos))
        da.decode_splits = decode_rule
        print(json.dumps(row), flush=True)
    c, nb = 128, 2176 // bs
    kp = torch.randn(nb + 1, bs, kv, hd, device=dev, dtype=torch.bfloat16)
    vp = torch.randn_like(kp)
    table = torch.from_numpy((rng.permutation(nb) + 1).astype(
        np.int32)).to(dev)
    q = torch.randn(c, h, hd, device=dev, dtype=torch.bfloat16)
    prefill_rule = fa.prefill_splits
    for p0 in (0, 512, 1024, 2048):
        row = {"kernel": "paged_prefill_attention", "C": c, "hd": hd,
               "pos": p0, "rule": prefill_rule(c, h, kv, hd, nb * bs),
               "ms": {}}
        for sp in range(1, 9):
            fa.prefill_splits = lambda *a, sp=sp: sp
            row["ms"][sp] = median_ms(
                lambda: fa.paged_prefill_attention(q, kp, vp, table, p0))
        fa.prefill_splits = prefill_rule
        print(json.dumps(row), flush=True)
    w = 1024
    nb = w // bs
    kp = torch.randn(nb + 1, bs, kv, hd, device=dev, dtype=torch.bfloat16)
    vp = torch.randn_like(kp)
    table = torch.from_numpy((rng.permutation(nb) + 1).astype(
        np.int32)).to(dev)
    kn = torch.randn(c, kv, hd, device=dev, dtype=torch.bfloat16)
    vn = torch.randn_like(kn)
    ring_rule = fa.ring_splits
    for p0 in (0, 512, 3000):
        row = {"kernel": "ring_chunk_attention", "C": c, "hd": hd, "w": w,
               "pos": p0, "rule": ring_rule(c, h, kv, hd, w, "mma"),
               "ms": {}}
        for sp in range(1, 9):
            fa.ring_splits = lambda *a, sp=sp: sp
            row["ms"][sp] = median_ms(lambda: fa.ring_chunk_attention(
                q, kp, vp, table, kn, vn, p0, w))
        fa.ring_splits = ring_rule
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
