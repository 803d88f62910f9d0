"""The port's kernels against the JAX package's.

On the CPU each kernel's plain PyTorch version is held against the
``repro.kernels.ref`` oracle and the Pallas kernel in interpret mode (as
tests/test_kernels.py runs them), on the same numpy inputs.  Tolerance:
test_kernels.py's float32 bound, 2e-5 (sums run in another order); for
the selective scan, whose outputs reach tens, 2e-5 of max(1, |value|).

rmsnorm fused with the residual add is held the same way in float32,
and in bfloat16 under the card's bf16 gate below: the residual ``r``
must equal the JAX package's ``x + a`` bit for bit.

The ``cuda``-marked tests hold each CUDA kernel against its plain
version on the card; they skip without a card.  float32: 2e-5 (the
scan: of max(1, |plain|)), except
the quant matmuls at 1e-4: their sums run over K up to 2560 in another
order than the plain version's K-chunked one, and an output of unit
size then differs by a few 1e-6 per thousand terms.  bfloat16: both
sides compute in f32 from the same bf16 inputs and round once at the
end, so an element may differ by one bf16 rounding step of its own
value (at most 2**-7 of it).  Each element must lie within two such
steps (2**-6 * |plain| + 1e-5 for values near zero), and the largest
difference within 2e-2.  A lost key tile or a wrong lane moves an
output by a sizeable share of its value and fails the first bound.
"""
import collections
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    DECODE_CHUNK, DECODE_MAX_SPLITS, SMEM_PER_BLOCK, WIDE_CLUSTERS,
    NEG_INF, decode_body, decode_smem_bytes, decode_splits,
    dense_decode_attention, dense_decode_attention_partial,
    dense_decode_attention_partial_plain, dense_decode_attention_plain,
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    CHUNK_MIN_TILES, CHUNK_SHORT_C, CHUNK_SHORT_SPLITS, CHUNK_WGMMA_HD,
    CROSS_MIN_TILES,
    CROSS_WGMMA_HD, PREFILL_ROWS, RING_WGMMA_HD, WGMMA_HD, WGMMA_ROWS,
    FlashAttentionFn, chunk_body, chunk_splits,
    cross_body, cross_splits, flash_attention, flash_attention_plain,
    flash_body, paged_chunk_attention, wgmma_smem_bytes, wgmma_tile_keys,
    paged_chunk_attention_plain, paged_cross_attention,
    paged_cross_attention_plain, paged_prefill_attention,
    paged_prefill_attention_plain, prefill_body, prefill_smem_bytes,
    prefill_span, prefill_splits, ring_body, ring_chunk_attention,
    ring_chunk_attention_plain, ring_positions, ring_splits)
from repro_torch.kernels import quant_matmul as qmm_mod  # noqa: E402
from repro_torch.kernels.quant_matmul import (  # noqa: E402
    MMA_MAX_SPLITS, MMA_STAGE_K, MMA_TILE_N, SM_COUNT, WGMMA_BUDGET,
    WGMMA_CLUSTERS, WGMMA_MAX_SPLITS, WGMMA_STAGE_K, WGMMA_TILE_N,
    int4_body, int8_body, quant_matmul_int4, quant_matmul_int4_plain,
    quant_matmul_int8, quant_matmul_int8_plain, quant_splits,
    wgmma_ctas_per_sm, wgmma_rows, wgmma_splits, wgmma_stage_bytes,
    wgmma_stages, wgmma_takes)
from repro_torch.kernels import rmsnorm as norm_mod  # noqa: E402
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    NORM_MAX_WARPS, NORM_VECS, add_rmsnorm, add_rmsnorm_plain,
    norm_lanes, norm_pack, rmsnorm, rmsnorm_plain)
from repro_torch.kernels import selective_scan as scan_mod  # noqa: E402
from repro_torch.kernels.selective_scan import (  # noqa: E402
    LANE_STATES, MAX_STATE, SCAN_LANES, scan_blocks, scan_body, scan_lanes,
    selective_scan, selective_scan_plain)
from repro_torch.models.quantize import (  # noqa: E402
    int4_group, quantize_int4, quantize_int8)

# smollm-360m's projection sites (K, N): wq / wo, wk / wv, w_gate /
# w_up, w_down
SMOLLM_SITES = [(960, 960), (960, 320), (960, 2560), (2560, 960)]
TOL = 2e-5                                   # float32, as test_kernels.py
CARD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
QMM_CARD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # sums over K <= 2560
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-5        # two bf16 rounding steps


@pytest.fixture(scope="module")
def J():
    """The JAX side (skipped where JAX is absent, as on the card's
    machine, which runs only the ``cuda`` tests of this file)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.kernels.decode_attention import (decode_attention_pallas,
                                                paged_decode_attention_pallas)
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.kernels.rmsnorm import rmsnorm_pallas
    from repro.kernels.selective_scan import selective_scan_pallas
    from repro.models import attention
    return SimpleNamespace(
        jax=jax, jnp=jnp, ref=ref, attention=attention,
        rmsnorm_pallas=rmsnorm_pallas,
        selective_scan_pallas=selective_scan_pallas,
        paged_decode_attention_pallas=paged_decode_attention_pallas,
        decode_attention_pallas=decode_attention_pallas,
        flash_attention_pallas=flash_attention_pallas)


@pytest.fixture
def cuda_device():
    """The card, or a skip with the reason (decided at run time, never
    at import, so every xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda is not available")
    return torch.device("cuda", 0)


def t(a):
    return torch.from_numpy(np.array(a))


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _card_close(got, want, dtype, tol=CARD_TOL) -> None:
    """``got`` (kernel) against ``want`` (plain), both on the card."""
    got, want = got.float().cpu(), want.float().cpu()
    assert _err(got, want) <= tol[dtype]
    if dtype == "bfloat16":
        diff = (got - want).abs()
        worst = (diff - BF16_RTOL * want.abs()).max().item()
        assert worst <= BF16_ATOL, (
            f"an element is off by more than two bf16 rounding steps "
            f"(excess {worst})")


def _paged_inputs(rng, b, h, kv, nb, bs, d):
    """q (B,H,D), pools in the model layout (NB,bs,KV,D), distinct
    tables over blocks 1.. (block 0 is scratch) and positions."""
    nbp = b * nb + 3
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    kp = rng.standard_normal((nbp, bs, kv, d), dtype=np.float32)
    vp = rng.standard_normal((nbp, bs, kv, d), dtype=np.float32)
    tables = (rng.permutation(nbp - 1)[:b * nb].reshape(b, nb) + 1
              ).astype(np.int32)
    pos = rng.integers(0, nb * bs, size=b).astype(np.int32)
    return q, kp, vp, tables, pos


# ----------------------------------------------------------------------
# rmsnorm
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(8, 128), (3, 37, 256), (2, 5, 7, 96)])
def test_rmsnorm_plain_matches_jax(J, shape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape, dtype=np.float32)
    scale = rng.standard_normal(shape[-1:], dtype=np.float32)
    got = rmsnorm_plain(t(x), t(scale), 1e-5).numpy()
    xj, sj = J.jnp.asarray(x), J.jnp.asarray(scale)
    assert _err(got, J.ref.rmsnorm_ref(xj, sj)) < TOL
    pallas = J.rmsnorm_pallas(xj, sj, interpret=True)
    assert _err(got, pallas) < TOL
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(rmsnorm(t(x), t(scale)), t(got))


NORM_SHAPES = [(8, 960), (128, 960), (5, 100)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", NORM_SHAPES)
def test_add_rmsnorm_plain_matches_jax(J, dtype, shape):
    """The residual add and the norm after it: ``r`` bit-equal to jnp's
    ``x + a`` in the same dtype, ``out`` against rmsnorm_ref and the
    Pallas kernel (interpret mode) on that r."""
    rng = np.random.default_rng(5)
    x, a = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    scale = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    dt = getattr(torch, dtype)
    tx, ta, ts = (t(v).to(dt) for v in (x, a, scale))
    r, out = add_rmsnorm_plain(tx, ta, ts, 1e-5)
    jx, ja, js = (J.jnp.asarray(v).astype(getattr(J.jnp, dtype))
                  for v in (x, a, scale))
    jr = jx + ja
    assert np.array_equal(r.float().numpy(), np.asarray(jr, np.float32))
    for want in (J.ref.rmsnorm_ref(jr, js),
                 J.rmsnorm_pallas(jr, js, interpret=True)):
        _card_close(out, t(np.asarray(want, np.float32)), dtype)
    # the wrapper takes the plain version for CPU tensors
    r2, out2 = add_rmsnorm(tx, ta, ts, 1e-5)
    assert torch.equal(r2, r) and torch.equal(out2, out)


@pytest.mark.parametrize("case", ["delta_shape", "delta_dtype",
                                  "delta_device", "x_strided",
                                  "delta_strided", "scale", "body",
                                  "norm_body", "add_norm_body"])
def test_rmsnorm_wrappers_refuse_without_a_launch(case):
    """A delta of another shape, dtype or device, a non-contiguous
    input, a scale that does not match, a body the kernel does not have
    or one that does not fit the call is refused before any launch."""
    _build.reset_launches()
    x = torch.empty((4, 64), device="meta")
    delta = torch.empty((4, 64), device="meta")
    scale = torch.empty(64, device="meta")
    kw, fn, match = {}, add_rmsnorm, "does not match"
    if case == "delta_shape":
        delta = torch.empty((4, 32), device="meta")
    elif case == "delta_dtype":
        delta = delta.to(torch.bfloat16)
    elif case == "delta_device":
        delta = torch.empty((4, 64))
    elif case == "x_strided":
        x, match = torch.empty((64, 4), device="meta").t(), "contiguous"
    elif case == "delta_strided":
        delta, match = torch.empty((64, 4), device="meta").t(), "contiguous"
    elif case == "scale":
        scale = torch.empty(32, device="meta")
    elif case == "body":
        kw, match = {"_body": "mma"}, "no kernel body"
    elif case == "norm_body":
        kw, match = {"_body": "norm"}, "takes no delta"
    else:
        kw, fn, match = {"_body": "add_norm"}, None, "needs a delta"
    with pytest.raises(ValueError, match=match):
        if fn is None:
            rmsnorm(x, scale, **kw)
        else:
            fn(x, delta, scale, **kw)
    assert all(n == 0 for n in _build.launches.values())
    assert all(n == 0 for n in _build.bodies["rmsnorm"].values())


@pytest.mark.parametrize("rows,d,dtype,want", [
    (8, 960, "bfloat16", (128, 1, 1)),      # smollm-360m decode
    (128, 960, "bfloat16", (128, 1, 1)),    # smollm-360m prefill chunk
    (8, 4096, "bfloat16", (256, 1, 2)),     # falcon-mamba-7b decode
    (128, 4096, "bfloat16", (256, 1, 2)),   # falcon-mamba-7b chunk
    (8, 960, "float32", (256, 1, 1)),       # the f32 parity runs
    (128, 960, "float32", (256, 1, 1)),
    (8, 4096, "float32", (256, 1, 4)),
    (128, 4096, "float32", (256, 1, 4)),
    (8, 100, "bfloat16", (128, 1, 1)),      # one element an access
    (1024, 128, "bfloat16", (32, 4, 1)),    # one warp a row, 4 a block
])
def test_norm_lanes_on_the_main_path(rows, d, dtype, want):
    """One 16-byte access a lane where up to 8 warps hold the row (every
    bf16 norm of both models), two at falcon-mamba-7b's bf16 width; one
    row a block unless a row fits one warp and there are rows enough to
    give every SM a block of more."""
    assert norm_lanes(rows, d, norm_pack(getattr(torch, dtype), d)) == want


@pytest.mark.parametrize("rows", [1, 5, 131, 132, 1055, 1056, 8192])
@pytest.mark.parametrize("d,pack", [(100, 1), (100, 4), (960, 1), (960, 8),
                                    (4096, 1), (4096, 8), (16384, 4),
                                    (32768, 8), (5, 1), (256, 8)])
def test_norm_lanes_hold_the_row_and_fill_the_card(rows, d, pack):
    """Every access of a row has a lane: one a lane in the fewest warps
    (a power of two) up to 8, then the fewest accesses a lane (a power
    of two, at most 16); one row a block when a row takes more than one
    warp, else the largest block of up to 8 rows that still gives every
    SM a block."""
    lanes, rpb, vecs = norm_lanes(rows, d, pack)
    n_acc = -(-d // pack)
    warps = lanes // 32
    assert lanes % 32 == 0 and warps & (warps - 1) == 0
    assert n_acc <= lanes * vecs and vecs in NORM_VECS
    assert vecs == 1 or n_acc > lanes * (vecs // 2)
    assert warps == 1 or n_acc > lanes // 2
    assert vecs == 1 or warps == NORM_MAX_WARPS
    assert warps * rpb <= NORM_MAX_WARPS and (warps == 1 or rpb == 1)
    assert rpb == 1 or -(-rows // rpb) >= SM_COUNT
    assert rpb == 8 or -(-rows // (2 * rpb)) < SM_COUNT or warps > 1


def test_norm_pack_and_width_refusal():
    bf, f32 = torch.bfloat16, torch.float32
    assert norm_pack(bf, 960) == 8 and norm_pack(f32, 960) == 4
    assert norm_pack(bf, 100) == 1 and norm_pack(f32, 100) == 4
    assert norm_pack(bf, 960, aligned=False) == 1
    with pytest.raises(ValueError, match="wider"):
        norm_lanes(1, 32768 + 8, 8)
    with pytest.raises(ValueError, match="wider"):
        norm_lanes(1, 4097, 1)


# ----------------------------------------------------------------------
# paged decode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,h,kv,nb,bs,d", [
    (3, 6, 2, 3, 8, 32),      # GQA, odd pool
    (2, 15, 5, 4, 16, 64),    # smollm-360m's heads
    (2, 4, 2, 3, 8, 256),     # gemma3-12b's head dim and G = 2
])
def test_paged_decode_plain_matches_jax(J, b, h, kv, nb, bs, d):
    rng = np.random.default_rng(4)
    q, kp, vp, tables, pos = _paged_inputs(rng, b, h, kv, nb, bs, d)
    got = paged_decode_attention_plain(t(q), t(kp), t(vp), t(tables),
                                       t(pos)).numpy()
    # the JAX kernel and oracle take (KV, NB, bs, D): transpose there only
    kj = J.jnp.asarray(np.transpose(kp, (2, 0, 1, 3)))
    vj = J.jnp.asarray(np.transpose(vp, (2, 0, 1, 3)))
    args = (J.jnp.asarray(q), kj, vj, J.jnp.asarray(tables),
            J.jnp.asarray(pos))
    assert _err(got, J.ref.paged_decode_attention_ref(*args)) < TOL
    assert _err(got, J.paged_decode_attention_pallas(
        *args, interpret=True)) < TOL
    assert torch.equal(paged_decode_attention(t(q), t(kp), t(vp), t(tables),
                                              t(pos)), t(got))


def test_paged_decode_plain_masked_row_reads_scratch_only():
    """A masked row (frozen pos, all-zero table) attends to the scratch
    block 0 alone: the result depends on nothing else in the pool."""
    rng = np.random.default_rng(5)
    q, kp, vp, tables, pos = _paged_inputs(rng, 2, 4, 2, 4, 8, 32)
    tables[1] = 0
    pos[1] = 3
    a = paged_decode_attention_plain(t(q), t(kp), t(vp), t(tables), t(pos))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[1:] = 0.0
    vp2[1:] = 0.0
    b = paged_decode_attention_plain(t(q), t(kp2), t(vp2), t(tables), t(pos))
    assert torch.equal(a[1], b[1])


# ----------------------------------------------------------------------
# dense decode
# ----------------------------------------------------------------------
def _dense_inputs(rng, b, h, kv, s, d):
    """q (B,H,D), caches in the model layout (B,S,KV,D), positions with
    a row at 0, one at S - 1 and one frozen past the cache (a row whose
    budget ran out keeps its last pos; every slot is then valid)."""
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    kc = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    vc = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    pos = rng.integers(0, s, size=b).astype(np.int32)
    pos[0], pos[1], pos[-1] = 0, s - 1, s + 5
    return q, kc, vc, pos


@pytest.mark.parametrize("b,h,kv,s,d", [
    (4, 6, 2, 24, 32),        # GQA
    (3, 15, 5, 80, 64),       # smollm-360m's heads, S past one tile
    (3, 4, 2, 24, 256),       # gemma3-12b's head dim and G = 2
])
def test_dense_decode_plain_matches_jax(J, b, h, kv, s, d):
    rng = np.random.default_rng(14)
    q, kc, vc, pos = _dense_inputs(rng, b, h, kv, s, d)
    got = dense_decode_attention_plain(t(q), t(kc), t(vc), t(pos)).numpy()
    # the JAX kernel and oracle take (B, KV, S, D): transpose there only
    kj = J.jnp.asarray(np.transpose(kc, (0, 2, 1, 3)))
    vj = J.jnp.asarray(np.transpose(vc, (0, 2, 1, 3)))
    args = (J.jnp.asarray(q), kj, vj, J.jnp.asarray(pos))
    assert _err(got, J.ref.decode_attention_ref(*args)) < TOL
    assert _err(got, J.decode_attention_pallas(
        *args, block_s=8, interpret=True)) < TOL
    assert torch.equal(dense_decode_attention(t(q), t(kc), t(vc), t(pos)),
                       t(got))


def test_dense_decode_plain_is_paged_on_one_block_per_row():
    """A dense cache is a paged pool of one S-slot block per row: the
    plain versions agree exactly there, as the kernels' shared body
    makes the CUDA kernels agree."""
    rng = np.random.default_rng(15)
    q, kc, vc, pos = _dense_inputs(rng, 3, 6, 2, 40, 32)
    tables = np.arange(3, dtype=np.int32)[:, None]
    assert torch.equal(
        dense_decode_attention_plain(t(q), t(kc), t(vc), t(pos)),
        paged_decode_attention_plain(t(q), t(kc), t(vc), t(tables), t(pos)))


# ----------------------------------------------------------------------
# paged prefill (the flash kernel's paged-chunk form)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("c,h,kv,d,bs", [(32, 4, 4, 32, 8),
                                         (48, 15, 5, 64, 16),
                                         (32, 4, 2, 256, 8)])   # gemma3's hd
def test_paged_prefill_at_pos0_is_flash_attention(J, c, h, kv, d, bs):
    """pos = 0 with an identity table over contiguous K/V computes what
    flash_attention_pallas(causal=True, window=0) computes."""
    rng = np.random.default_rng(6)
    nb = -(-c // bs) + 1
    q = rng.standard_normal((c, h, d), dtype=np.float32)
    k = rng.standard_normal((nb * bs, kv, d), dtype=np.float32)
    v = rng.standard_normal((nb * bs, kv, d), dtype=np.float32)
    table = np.arange(nb, dtype=np.int32)
    got = paged_prefill_attention_plain(
        t(q), t(k.reshape(nb, bs, kv, d)), t(v.reshape(nb, bs, kv, d)),
        t(table), 0).numpy()
    qj = J.jnp.asarray(np.transpose(q, (1, 0, 2))[None])            # (1,H,C,D)
    kj = J.jnp.asarray(np.transpose(k[:c], (1, 0, 2))[None])        # (1,KV,C,D)
    vj = J.jnp.asarray(np.transpose(v[:c], (1, 0, 2))[None])
    want = np.transpose(np.asarray(
        J.flash_attention_pallas(qj, kj, vj, causal=True, window=0,
                                 block_q=16, block_k=16, interpret=True))[0],
        (1, 0, 2))
    assert _err(got, want) < TOL
    oracle = np.transpose(np.asarray(
        J.ref.flash_attention_ref(qj, kj, vj, causal=True))[0], (1, 0, 2))
    assert _err(got, oracle) < TOL


@pytest.mark.parametrize("pos,h,kv", [(5, 6, 2), (16, 4, 4), (40, 6, 2)])
def test_paged_prefill_at_pos_matches_chunk_path(J, pos, h, kv):
    """pos > 0: the plain version against the reference's jnp paged
    chunk attention (the gather, _gqa_scores, kpos <= qpos mask, softmax
    and _gqa_out lines of paged_chunk_self_attention; an identity wo
    leaves _gqa_out's projection exact)."""
    c, d, bs, nb = 12, 32, 8, 8
    rng = np.random.default_rng(7 + pos)
    q = rng.standard_normal((c, h, d), dtype=np.float32)
    kp = rng.standard_normal((nb + 2, bs, kv, d), dtype=np.float32)
    vp = rng.standard_normal((nb + 2, bs, kv, d), dtype=np.float32)
    table = (rng.permutation(nb + 1)[:nb] + 1).astype(np.int32)
    got = paged_prefill_attention_plain(t(q), t(kp), t(vp), t(table),
                                        pos).numpy()

    class Cfg:
        n_heads, n_kv_heads, head_dim = h, kv, d
    tables = J.jnp.asarray(table[None])
    kg = J.attention._paged_gather(J.jnp.asarray(kp), tables)
    vg = J.attention._paged_gather(J.jnp.asarray(vp), tables)
    scores = J.attention._gqa_scores(J.jnp.asarray(q[None]), kg, Cfg)
    qpos = (pos + J.jnp.arange(c))[None, None, :, None]
    kpos = J.jnp.arange(nb * bs)[None, None, None, :]
    mask = J.jnp.where(kpos <= qpos, 0.0, J.attention.NEG_INF)
    scores = scores + mask.astype(J.jnp.float32)[:, :, None]
    probs = J.jax.nn.softmax(scores, axis=-1)
    want = J.attention._gqa_out(probs, vg, {"wo": J.jnp.eye(h * d)}, Cfg,
                                J.jnp.float32)
    assert _err(got, np.asarray(want).reshape(c, h, d)) < TOL


# ----------------------------------------------------------------------
# ring chunk (the flash kernel's window form)
# ----------------------------------------------------------------------
def _ring_inputs(rng, pos, c, w, h, kv, d, bs):
    """A sequence of pos + C tokens' q / k / v, the ring of w slots as a
    request at pos holds it (slot j: the latest position p < pos with
    p % w == j, stale noise where none was written yet) in shuffled
    blocks of bs, and the chunk's own keys."""
    n = pos + c
    q = rng.standard_normal((n, h, d), dtype=np.float32)
    k = rng.standard_normal((n, kv, d), dtype=np.float32)
    v = rng.standard_normal((n, kv, d), dtype=np.float32)
    nb = -(-w // bs)
    ring_k = rng.standard_normal((nb * bs, kv, d), dtype=np.float32)
    ring_v = rng.standard_normal((nb * bs, kv, d), dtype=np.float32)
    p_old = ring_positions(pos, w, 0, "cpu").numpy()
    live = p_old >= 0
    ring_k[:w][live], ring_v[:w][live] = k[p_old[live]], v[p_old[live]]
    table = (rng.permutation(nb + 1)[:nb] + 1).astype(np.int32)
    kp = rng.standard_normal((nb + 2, bs, kv, d), dtype=np.float32)
    vp = rng.standard_normal((nb + 2, bs, kv, d), dtype=np.float32)
    kp[table], vp[table] = (ring_k.reshape(nb, bs, kv, d),
                            ring_v.reshape(nb, bs, kv, d))
    return q, k, v, kp, vp, table


@pytest.mark.parametrize("pos,c,h,kv", [(0, 16, 4, 4), (20, 12, 6, 2),
                                        (31, 17, 4, 4), (70, 26, 6, 2),
                                        (48, 48, 6, 2)])
def test_ring_chunk_is_windowed_flash_attention(J, pos, c, h, kv):
    """The ring form's plain version computes the last C rows of
    flash_attention_pallas(causal=True, window=w) over the whole
    sequence [0, pos + C) (a whole number of the Pallas kernel's blocks
    of 16): the ring holds the w positions before the chunk (stale slots
    masked), the chunk its own keys; at pos 0 no ring key is valid, and
    with C > w the chunk's early keys leave the window of its late
    queries."""
    w, d, bs = 32, 32, 16
    rng = np.random.default_rng(9 + pos)
    q, k, v, kp, vp, table = _ring_inputs(rng, pos, c, w, h, kv, d, bs)
    got = ring_chunk_attention_plain(
        t(q[pos:]), t(kp), t(vp), t(table), t(k[pos:]), t(v[pos:]), pos,
        w).numpy()
    qj = J.jnp.asarray(np.transpose(q, (1, 0, 2))[None])
    kj = J.jnp.asarray(np.transpose(k, (1, 0, 2))[None])
    vj = J.jnp.asarray(np.transpose(v, (1, 0, 2))[None])
    want = np.transpose(np.asarray(
        J.flash_attention_pallas(qj, kj, vj, causal=True, window=w,
                                 block_q=16, block_k=16, interpret=True))[0],
        (1, 0, 2))[pos:]
    assert _err(got, want) < TOL
    oracle = np.transpose(np.asarray(J.ref.flash_attention_ref(
        qj, kj, vj, causal=True, window=w))[0], (1, 0, 2))[pos:]
    assert _err(got, oracle) < TOL


def test_ring_wrapper_refuses_other_devices_and_counts_no_cpu_launches():
    _build.reset_launches()
    rng = np.random.default_rng(10)
    q, k, v, kp, vp, table = _ring_inputs(rng, 40, 8, 32, 4, 2, 16, 16)
    ring_chunk_attention(t(q[40:]), t(kp), t(vp), t(table), t(k[40:]),
                         t(v[40:]), 40, 32)
    assert _build.launches["ring_chunk_attention"] == 0
    q = torch.empty((4, 2, 8), device="meta")
    pool = torch.empty((3, 16, 2, 8), device="meta")
    kn = torch.empty((4, 2, 8), device="meta")
    with pytest.raises(ValueError):
        ring_chunk_attention(q, pool, pool,
                             torch.empty((2,), dtype=torch.int32,
                                         device="meta"), kn, kn, 0, 32)
    assert all(n == 0 for n in _build.launches.values())


@pytest.mark.parametrize("pos,c", [(0, 16), (20, 8), (31, 16), (45, 64),
                                   (200, 48)])
def test_ring_plain_takes_a_device_pos_tensor(pos, c):
    """The plain version given ``pos`` as a (1,) int32 tensor (the
    kernel's device-pos form) equals the host-int call bit for bit, and
    the wrapper takes it on the CPU without a launch."""
    rng = np.random.default_rng(11 + pos)
    w, h, kv, d = 32, 6, 2, 32
    q, k, v, kp, vp, table = _ring_inputs(rng, pos, c, w, h, kv, d, 16)
    args = (t(q[pos:]), t(kp), t(vp), t(table), t(k[pos:]), t(v[pos:]))
    want = ring_chunk_attention_plain(*args, pos, w)
    pos_t = torch.tensor([pos], dtype=torch.int32)
    assert torch.equal(ring_chunk_attention_plain(*args, pos_t, w), want)
    _build.reset_launches()
    assert torch.equal(ring_chunk_attention(*args, pos_t, w), want)
    assert _build.launches["ring_chunk_attention"] == 0


@pytest.mark.parametrize("dtype,hd,aligned,want", [
    ("bfloat16", 256, True, "mma"),     # gemma3-12b: the wide tiles
    ("bfloat16", 128, True, "wgmma"),   # mixtral-8x7b
    ("bfloat16", 64, True, "wgmma"), ("bfloat16", 32, True, "mma"),
    ("bfloat16", 16, True, "mma"), ("bfloat16", 112, True, "wgmma"),
    ("bfloat16", 30, True, "cuda_core"), ("bfloat16", 144, True, "cuda_core"),
    ("bfloat16", 240, True, "cuda_core"), ("bfloat16", 512, True, "cuda_core"),
    ("bfloat16", 256, False, "cuda_core"), ("bfloat16", 64, False, "cuda_core"),
    ("float32", 256, True, "cuda_core"), ("float32", 64, True, "cuda_core"),
    ("float32", 128, True, "cuda_core"),
])
def test_ring_body_rule(dtype, hd, aligned, want):
    """The window form takes the wgmma body for bf16 at hd 64, 112 and
    128 (``RING_WGMMA_HD``: mixtral-8x7b's 128 among them) on aligned
    tensors, else the tensor-core ``mma`` body exactly where the paged
    prefill's base rule names it (bf16, aligned, whole k16 steps up to
    128, or 256), and the CUDA-core body elsewhere: float32 always, so
    the card's f32 streams stay equal to the CPU's.  A ring in blocks
    that do not cut into 8-slot TMA segments keeps ``mma``."""
    dt = getattr(torch, dtype)
    assert ring_body(dt, hd, aligned) == want
    if want != "wgmma":
        assert ring_body(dt, hd, aligned) == prefill_body(dt, hd, aligned)
    else:
        assert hd in RING_WGMMA_HD
        assert ring_body(dt, hd, aligned, segments=False) == "mma"


def _ring_tiles(pos, w, c, g, r0, hd, splits):
    """The key tiles each CTA of a row tile's cluster takes in the window
    form's mma body (csrc/ring_chunk_attention.cu::mma::ring_mma_kernel),
    for the tile of rows r0 .. r0 + 63: per CTA, a list of (source,
    first key) of kTileK keys, ring steps then chunk steps."""
    span = prefill_span(hd)
    tile_k = span // 2
    rlast = min(r0 + PREFILL_ROWS, c * g) - 1
    q_last = rlast // g
    n_old = min(pos, w)
    n_rs = -(-n_old // span)
    nst = n_rs + q_last // span + 1
    per = -(-nst // splits)
    steps = [("ring", it * span) if it < n_rs else
             ("chunk", (it - n_rs) * span) for it in range(nst)]
    return [[(src, k0 + grp * tile_k) for src, k0 in steps[r * per:
                                                           r * per + per]
             for grp in range(2)] for r in range(splits)], q_last, tile_k


def _ring_seen_masked(src, k0, tile_k, pos, w, wq_first, wq_last):
    """A key group's decision on its tile (the kernel's, mirrored): is any
    key seen by a row of the warp, and does the tile need the mask."""
    n_old, pos_mod = min(pos, w), pos % w
    if src == "ring":
        n = min(tile_k, n_old - k0)
        d0 = (k0 - pos_mod) % w
        wraps = d0 + n - 1 >= w
        return (n > 0 and (wraps or d0 + n - 1 > wq_first),
                n < tile_k or wraps or d0 <= wq_last)
    return (k0 <= wq_last and k0 + tile_k - 1 > wq_first - w,
            k0 + tile_k - 1 > wq_first or k0 <= wq_last - w)


@pytest.mark.parametrize("c,h,kv,hd,w", [
    (128, 16, 8, 256, 1024),     # gemma3-12b's prefill chunk
    (128, 32, 8, 128, 4096),     # mixtral-8x7b's
    (160, 16, 8, 256, 128),      # a chunk longer than the ring, wide
    (64, 6, 2, 32, 32), (33, 4, 4, 64, 48), (5, 6, 2, 32, 32),
    (1, 16, 8, 256, 1024),
])
def test_ring_splits_cover_the_keys_and_fill_the_card(c, h, kv, hd, w):
    """The window form's split depends on shapes alone, fills the card in
    one wave of clusters at hd 256 (1 below), and at every pos (0, inside
    the first lap, w - 1, w and far past it) its steps hand each logical
    key of ``[ring ; chunk]`` a row tile needs to exactly one key group
    of exactly one CTA.  A key group skips a tile only where no row of
    its warp sees a key of it, and leaves the mask off only where every
    row sees every key (the plain version's mask)."""
    splits = ring_splits(c, h, kv, hd, w)
    g = h // kv
    span = prefill_span(hd)
    tiles = -(-c * g // PREFILL_ROWS)
    if hd <= 128:
        assert splits == 1
    else:
        _one_wave_and_most(tiles * kv, splits, -(-w // span) + -(-c // span))
    if (c, h, kv, hd, w) == (128, 16, 8, 256, 1024):
        assert splits == 3       # 4 row tiles x 8 KV heads x 3 = 96 CTAs
    for pos in (0, w // 2, w - 1, w, w + 7, 3 * w + 100):
        n_old, pos_mod = min(pos, w), pos % w
        for r0 in range(0, c * g, PREFILL_ROWS):
            shares, q_last, tile_k = _ring_tiles(pos, w, c, g, r0, hd,
                                                 splits)
            keys = [(src, k) for share in shares for src, k0 in share
                    for k in range(k0, k0 + tile_k)
                    if k < (n_old if src == "ring" else q_last + 1)]
            assert sorted(keys) == sorted(
                [("ring", j) for j in range(n_old)]
                + [("chunk", i) for i in range(q_last + 1)])
            rlast = min(r0 + PREFILL_ROWS, c * g) - 1
            for wr0 in range(r0, rlast + 1, 16):
                qi = np.arange(wr0, min(wr0 + 16, rlast + 1))[:, None] // g
                for src, k0 in (tk for share in shares for tk in share):
                    seen, masked = _ring_seen_masked(
                        src, k0, tile_k, pos, w, int(qi.min()),
                        int(qi.max()))
                    key = np.arange(k0, k0 + tile_k)[None, :]
                    if src == "ring":
                        valid = (key < n_old) & ((key - pos_mod) % w > qi)
                    else:
                        valid = (key <= qi) & (key > qi - w)
                    assert seen or not valid.any()
                    assert masked or valid.all()


# ----------------------------------------------------------------------
# selective scan
# ----------------------------------------------------------------------
def _scan_inputs(rng, b, t_, di, ds):
    """dt = softplus(N(0,1)), B, C, x and h0 N(0,1), A = -|N(0,1)|, as
    tests/test_kernels.py draws them."""
    dt = np.log1p(np.exp(rng.standard_normal((b, t_, di), dtype=np.float32)))
    bm = rng.standard_normal((b, t_, ds), dtype=np.float32)
    cm = rng.standard_normal((b, t_, ds), dtype=np.float32)
    x = rng.standard_normal((b, t_, di), dtype=np.float32)
    a_neg = -np.abs(rng.standard_normal((di, ds), dtype=np.float32))
    h0 = rng.standard_normal((b, di, ds), dtype=np.float32)
    return dt, bm, cm, x, a_neg, h0


def _rel_err(a, b) -> float:
    """Largest difference relative to max(1, |b|): the scan's outputs
    reach tens, so the f32 bound is taken against their size."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))


@pytest.mark.parametrize("b,t_,di,ds", [
    (1, 64, 128, 16),
    (2, 100, 256, 16),     # t not a multiple of the Pallas chunk
    (2, 128, 512, 8),
    (3, 1, 256, 16),       # a decode step
])
def test_selective_scan_plain_matches_jax(J, b, t_, di, ds):
    """The plain scan, h0 aliased with h_T as the model calls it,
    against the oracle and the Pallas kernel in interpret mode (within
    2e-5 of max(1, |value|))."""
    rng = np.random.default_rng(16)
    dt, bm, cm, x, a_neg, h0 = _scan_inputs(rng, b, t_, di, ds)
    h = t(h0)
    y, h_t = selective_scan_plain(t(dt), t(bm), t(cm), t(x), t(a_neg), h,
                                  h_out=h)
    assert h_t is h and y.shape == (b, t_, di)
    args = [J.jnp.asarray(a) for a in (dt, bm, cm, x, a_neg, h0)]
    for want_y, want_h in (
            J.ref.selective_scan_ref(*args),
            J.selective_scan_pallas(*args, block_di=128, chunk_t=64,
                                    interpret=True)):
        assert _rel_err(y, want_y) < TOL
        assert _rel_err(h, want_h) < TOL
    # the wrapper takes the plain version for CPU tensors, h_T fresh
    y2, h2 = selective_scan(t(dt), t(bm), t(cm), t(x), t(a_neg), t(h0))
    assert torch.equal(y2, y) and torch.equal(h2, h)


def test_selective_scan_plain_reads_strided_b_and_c():
    """B and C as column slices of one wider tensor (x_proj's output in
    a float32 model) give what their contiguous copies give."""
    rng = np.random.default_rng(17)
    dt, bm, cm, x, a_neg, h0 = _scan_inputs(rng, 2, 9, 40, 8)
    proj = t(np.concatenate([rng.standard_normal((2, 9, 3), dtype=np.float32),
                             bm, cm], axis=-1))
    bs, cs = proj[..., 3:11], proj[..., 11:]
    assert not bs.is_contiguous()
    strided = selective_scan_plain(t(dt), bs, cs, t(x), t(a_neg), t(h0))
    dense = selective_scan_plain(t(dt), t(bm), t(cm), t(x), t(a_neg), t(h0))
    assert all(torch.equal(a, b) for a, b in zip(strided, dense))


@pytest.mark.parametrize("b,di,ds", [
    (8, 8192, 16),        # falcon-mamba-7b decode, 8 rows
    (1, 8192, 16),        # falcon-mamba-7b prefill chunk (and 1-row decode)
    (4, 8192, 16),
    (2, 300, 5), (2, 300, 8), (2, 300, 16),   # ragged d_inner and d_state
    (3, 256, 1), (1, 40, 3),
    (8, 7168, 64),        # zamba2-7b decode, 8 rows
    (1, 7168, 64),        # zamba2-7b prefill chunk
    (1, 40, 64), (2, 300, 40),
])
def test_scan_body_and_lanes_fill_the_card(b, di, ds):
    """Every d_state of 1..64 takes the state_lanes body.  Its lane count
    is one the kernel holds, no larger than d_state rounded up to a
    power of two.  Up to d_state 16 (at most 4 states a lane) it is the
    smallest that gives every SM a block, else the largest allowed;
    above, the smallest whose lanes hold at most ``LANE_STATES`` states
    each."""
    assert scan_body(ds) == "state_lanes"
    g = scan_lanes(b, di, ds)
    cap = max(SCAN_LANES[0], 1 << (ds - 1).bit_length())
    allowed = [x for x in SCAN_LANES if x <= cap]
    assert g in allowed and -(-ds // g) <= 4
    if ds > 16:
        assert all(-(-ds // x) > LANE_STATES for x in allowed if x < g)
    else:
        assert scan_blocks(b, di, g) >= SM_COUNT or g == allowed[-1]
        assert all(scan_blocks(b, di, x) < SM_COUNT
                   for x in allowed if x < g)
    if di == 8192 and ds == 16:   # falcon-mamba-7b: 256 blocks a row
        assert g == 4 and scan_blocks(b, di, g) == 256 * b
    if di == 7168 and ds == 64:   # zamba2-7b: 896 blocks a row
        assert g == 16 and scan_blocks(b, di, g) == 896 * b


@pytest.mark.parametrize("ds,body,match", [
    (0, None, "d_state"), (65, None, "d_state"), (32, "cuda_core", "d_state"),
    (16, "mma", "body"), (16, "lanes", "body"),
])
def test_scan_refuses_d_state_and_unknown_body_without_a_launch(ds, body,
                                                               match):
    """A d_state outside 1..64 (the previous body: outside 1..16 and
    64), or a body the kernel does not have, is refused before any
    launch, whatever the device."""
    _build.reset_launches()
    seq = torch.empty((2, 3, 64), device="meta")
    st = torch.empty((2, 3, ds), device="meta")
    with pytest.raises(ValueError, match=match):
        selective_scan(seq, st, st, seq,
                       torch.empty((64, ds), device="meta"),
                       torch.empty((2, 64, ds), device="meta"),
                       _body=body)
    if not 1 <= ds <= MAX_STATE:
        with pytest.raises(ValueError, match="d_state"):
            scan_body(ds)
    assert all(n == 0 for n in _build.launches.values())
    assert all(n == 0 for n in _build.bodies["selective_scan"].values())


# ----------------------------------------------------------------------
# wrappers: plain only for CPU tensors, a launch or an error otherwise
# ----------------------------------------------------------------------
def test_wrappers_refuse_other_devices_and_count_no_cpu_launches():
    _build.reset_launches()
    x = torch.zeros((2, 8))
    rmsnorm(x, torch.ones(8))
    assert all(n == 0 for n in _build.launches.values())
    meta = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError):
        rmsnorm(meta, torch.ones(8, device="meta"))
    q = torch.empty((1, 2, 8), device="meta")
    pool = torch.empty((3, 4, 2, 8), device="meta")
    with pytest.raises(ValueError):
        paged_decode_attention(q, pool, pool,
                               torch.empty((1, 2), dtype=torch.int32,
                                           device="meta"),
                               torch.empty((1,), dtype=torch.int32,
                                           device="meta"))
    with pytest.raises(ValueError):
        paged_prefill_attention(q[0], pool, pool,
                                torch.empty((2,), dtype=torch.int32,
                                            device="meta"), 0)
    with pytest.raises(ValueError):
        dense_decode_attention(q, pool[:1], pool[:1],
                               torch.empty((1,), dtype=torch.int32,
                                           device="meta"))
    xm = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError):
        quant_matmul_int8(xm, torch.empty((8, 4), dtype=torch.int8,
                                          device="meta"),
                          torch.empty((1, 4), device="meta"))
    with pytest.raises(ValueError):
        quant_matmul_int4(xm, torch.empty((4, 4), dtype=torch.uint8,
                                          device="meta"),
                          torch.empty((1, 4), device="meta"))
    seq, st = torch.empty((1, 3, 8), device="meta"), torch.empty(
        (1, 3, 4), device="meta")
    with pytest.raises(ValueError):
        selective_scan(seq, st, st, seq, torch.empty((8, 4), device="meta"),
                       torch.empty((1, 8, 4), device="meta"))
    assert all(n == 0 for n in _build.launches.values())


# ----------------------------------------------------------------------
# the rule that names a two-body kernel's body
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype,want", [("bfloat16", "mma"),
                                        ("float32", "cuda_core")])
def test_body_rule_on_the_main_path(dtype, want):
    """Every launch smollm-360m makes takes a tensor-core body in
    bfloat16 (hd 64 on ``mma`` for the prefill rule; int4 groups of 64 at
    every projection site on ``wgmma`` at decode, and at a 128-row chunk
    on ``mma`` at the attention projections, below
    ``WGMMA_INT4_CHUNK_MIN``) and the CUDA-core body in float32."""
    dt = getattr(torch, dtype)
    assert prefill_body(dt, 64) == want
    for k, n in SMOLLM_SITES:
        assert int4_body(dt, 8, k, n, int4_group(k)) == (
            "wgmma" if want == "mma" else want)
        assert int4_body(dt, 128, k, n, int4_group(k)) == (
            want if want == "cuda_core"
            else "mma" if n < 2560 and k < 2560 else "wgmma")


def test_body_rule_off_the_tiles():
    """Shapes the tensor-core tiles do not take keep the CUDA-core body
    in bfloat16 too."""
    bf = torch.bfloat16
    for hd in (128, 32, 256):
        assert prefill_body(bf, hd) == "mma"
    for hd in (8, 72, 100, 144, 240, 512):
        assert prefill_body(bf, hd) == "cuda_core"
    assert prefill_body(bf, 64, aligned=False) == "cuda_core"
    assert int4_body(bf, 8, 64, 48, 32) == "wgmma"
    for k, n, g in ((64, 7, 2), (960, 300, 64), (960, 320, 8),
                    (960, 320, 24), (960, 320, 100)):
        assert int4_body(bf, 8, k, n, g) == "cuda_core"
    assert int4_body(bf, 8, 960, 320, 64, aligned=False) == "cuda_core"


#: qwen2-72b's and command-r-35b's MLP (w_gate / w_up, w_down)
TARGET_SITES = [(8192, 29568), (29568, 8192), (8192, 22528), (22528, 8192)]


@pytest.mark.parametrize("m", [1, 8, 37, 128])
@pytest.mark.parametrize("k,n", SMOLLM_SITES + [(96, 48), (66, 7), (64, 16)]
                         + TARGET_SITES)
def test_int4_splits_cover_k_and_fill_the_card(m, k, n):
    """Every slice of K holds at least one stage, a tile's slices fit one
    portable cluster, and a decode-sized product has at least one CTA per
    SM unless K ran out of stages or the cluster out of room."""
    stages = -(-k // MMA_STAGE_K)
    splits = quant_splits(m, k, n)
    per = -(-stages // splits)
    assert 1 <= splits <= min(stages, MMA_MAX_SPLITS)
    assert (splits - 1) * per < stages
    if m <= 16:
        assert (-(-n // MMA_TILE_N) * splits >= SM_COUNT
                or splits == min(stages, MMA_MAX_SPLITS))


#: qwen2-72b's attention projections (wq / wo, wk / wv), the sites of
#: its packed layers beside TARGET_SITES' MLP
QWEN_ATTN_SITES = [(8192, 8192), (8192, 1024)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k,n", SMOLLM_SITES + TARGET_SITES
                         + QWEN_ATTN_SITES)
def test_quant_wgmma_rule_on_the_served_sites(dtype, k, n):
    """Every projection site of smollm-360m, qwen2-72b and command-r-35b
    takes the wgmma body in bfloat16, int4 at the group the packer
    picks at up to 64 rows, and above 64 from ``WGMMA_INT4_CHUNK_MIN``
    values up (smollm-360m's attention projections keep mma), int8 from
    ``WGMMA_INT8_MIN_BYTES`` of weight up at any rows (qwen2-72b's and
    command-r-35b's sites; smollm-360m's keep mma); the CUDA-core body
    in float32; unaligned x or q take the CUDA-core body, an unaligned
    int4 s the mma body."""
    dt = getattr(torch, dtype)
    want = "wgmma" if dtype == "bfloat16" else "cuda_core"
    g = int4_group(k)
    assert wgmma_takes(k, n) and wgmma_takes(k, n, g)
    small = k * n < qmm_mod.WGMMA_INT8_MIN_BYTES
    assert small == ((k, n) in SMOLLM_SITES)
    small4 = k * n < qmm_mod.WGMMA_INT4_CHUNK_MIN
    assert small4 == ((k, n) in SMOLLM_SITES[:2])
    assert int8_body(dt, k, n) == ("mma" if small and want == "wgmma"
                                   else want)
    for m in (1, 8, 37, 64):
        assert int4_body(dt, m, k, n, g) == want
    for m in (65, 128, 4096):
        assert int4_body(dt, m, k, n, g) == (
            "mma" if small4 and want == "wgmma" else want)
    assert int8_body(dt, k, n, aligned=False) == "cuda_core"
    assert int4_body(dt, 8, k, n, g, aligned=False) == "cuda_core"
    assert int4_body(dt, 8, k, n, g, s_aligned=False) == (
        "mma" if want == "wgmma" else want)


@pytest.mark.parametrize("k,n,group", [(960, 8, 64), (962, 960, None),
                                       (40, 32, None), (960, 300, 64),
                                       (960, 320, 24), (960, 320, 8),
                                       (66, 7, 2)])
def test_quant_wgmma_rule_off_its_shapes(k, n, group):
    """Shapes the wgmma body does not take (N or K off 16, int4 groups
    off whole k16 steps) keep the CUDA-core body in bfloat16."""
    bf = torch.bfloat16
    assert not wgmma_takes(k, n, group)
    if group is None:
        assert int8_body(bf, k, n) == "cuda_core"
    else:
        assert int4_body(bf, 8, k, n, group) == "cuda_core"


def _largest_split(stages: int) -> int:
    """The most slices of ``stages`` whole stages a portable cluster
    takes with none empty."""
    return max(sp for sp in range(1, min(stages, WGMMA_MAX_SPLITS) + 1)
               if (sp - 1) * -(-stages // sp) < stages)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("m", [1, 8, 37, 128])
@pytest.mark.parametrize("k,n", SMOLLM_SITES + [(96, 48), (64, 16),
                                                (160, 208)]
                         + TARGET_SITES + QWEN_ATTN_SITES)
def test_wgmma_splits_cover_k_and_fill_the_card(fmt, m, k, n):
    """The wgmma body's split: every slice of K holds at least one whole
    stage, a tile's slices fit one portable cluster, and a decode-sized
    product's CTAs fill at least three quarters of the SMs unless K ran
    out of stages or the cluster out of room (int8 at smollm-360m's 8 x
    960 -> 2560 runs fastest on 100 CTAs, PERF.md); the rows a CTA takes
    are wgmma's N."""
    rows = wgmma_rows(fmt, m)
    assert rows in (8, 16, 32, 64, 128)
    assert rows >= min(m, 128)
    stages = -(-k // WGMMA_STAGE_K)
    splits = wgmma_splits(fmt, m, k, n)
    per = -(-stages // splits)
    assert 1 <= splits <= min(stages, WGMMA_MAX_SPLITS)
    assert (splits - 1) * per < stages
    if m <= 16:
        assert (-(-n // WGMMA_TILE_N) * splits >= 3 * SM_COUNT // 4
                or splits == _largest_split(stages))
    # shapes alone: the same shapes give the same split
    assert wgmma_splits(fmt, m, k, n) == splits


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("rows", [8, 16, 32, 64, 128])
def test_wgmma_ring_fits_and_keeps_bytes_in_flight(fmt, rows):
    """The mirrored ring of the wgmma body: a block's shared memory fits
    227 KB, the body's CTAs an SM fit the SM's 228 KB (1 KB reserved a
    block), the partial tile of a split fits the ring, and at decode
    rows a CTA keeps at least 32 KB of weight in flight (all stages but
    the one being read)."""
    smem = qmm_mod.wgmma_smem_bytes(fmt, rows)
    stages = wgmma_stages(fmt, rows)
    ctas = wgmma_ctas_per_sm(rows)
    assert smem <= 232448
    assert ctas * (smem + 1024) <= 233472
    assert stages * wgmma_stage_bytes(fmt, rows) <= WGMMA_BUDGET[ctas]
    assert rows * (WGMMA_TILE_N + 4) * 4 <= stages * wgmma_stage_bytes(
        fmt, rows)
    w_stage = (WGMMA_STAGE_K // (2 if fmt == "int4" else 1)) * WGMMA_TILE_N
    if rows <= 16:
        assert (stages - 1) * w_stage >= 32 * 1024
    assert set(WGMMA_CLUSTERS[ctas]) == set(range(1, 9))


@pytest.mark.parametrize("dtype,want", [("bfloat16", "mma"),
                                        ("float32", "cuda_core")])
def test_int8_and_decode_body_rules_on_the_main_path(dtype, want):
    """Every int8 projection and every decode attention smollm-360m runs
    takes the tensor-core body in bfloat16 (hd 64, G = 3; int8's weights
    there are below ``WGMMA_INT8_MIN_BYTES``, so ``mma``) and the
    CUDA-core body in float32, paged and dense alike."""
    dt = getattr(torch, dtype)
    for k, n in SMOLLM_SITES:
        assert int8_body(dt, k, n) == want
    assert decode_body(dt, 64, 3) == want


def test_int8_and_decode_body_rules_off_the_tiles():
    """Shapes the tensor-core tiles do not take keep the CUDA-core body
    in bfloat16 too."""
    bf = torch.bfloat16
    assert int8_body(bf, 96, 48) == "mma"
    assert int8_body(bf, 48, 16) == "mma"
    for k, n in ((128, 300), (66, 7), (960, 8), (962, 960), (40, 32)):
        assert int8_body(bf, k, n) == "cuda_core"
    assert int8_body(bf, 960, 960, aligned=False) == "cuda_core"
    for hd, g in ((16, 1), (32, 3), (128, 8), (64, 16), (256, 4), (256, 2),
                  (256, 8)):
        assert decode_body(bf, hd, g) == "mma"
    for hd, g in ((8, 3), (72, 3), (100, 2), (64, 17), (256, 9), (240, 2),
                  (144, 2)):
        assert decode_body(bf, hd, g) == "cuda_core"
    assert decode_body(bf, 64, 3, aligned=False) == "cuda_core"


def _decode_shares(klast: int, splits: int) -> list:
    """The 16-slot chunks [c0, c1) each CTA of a cluster takes for a row
    whose last live slot is ``klast`` (csrc/decode_attention.cuh::
    decode_split)."""
    nch = klast // DECODE_CHUNK + 1 if klast >= 0 else 0
    per = -(-nch // splits)
    return [(r * per, min(r * per + per, nch)) for r in range(splits)]


@pytest.mark.parametrize("b,kv,capacity", [
    (8, 5, 1024),        # smollm-360m's paged and slot decode
    (1, 5, 1024), (4, 5, 256), (16, 5, 1024), (64, 8, 4096),
    (3, 2, 24), (2, 2, 16), (1, 1, 8),
])
def test_decode_splits_cover_the_slots_and_fill_the_card(b, kv, capacity):
    """The split fits one portable cluster, asks for no more CTAs than
    the row has 16-slot chunks, fills the card with about two CTAs per
    SM where it can, and its shares cover every live slot exactly once
    at every pos (a share past klast is empty)."""
    splits = decode_splits(b, kv, capacity, 64)
    chunks = -(-capacity // DECODE_CHUNK)
    assert 1 <= splits <= min(DECODE_MAX_SPLITS, chunks)
    assert (b * kv * splits >= 2 * SM_COUNT
            or splits == min(DECODE_MAX_SPLITS, chunks))
    for klast in range(-1, capacity):
        shares = _decode_shares(klast, splits)
        covered = [c for c0, c1 in shares for c in range(c0, c1)]
        assert covered == list(range(klast // DECODE_CHUNK + 1
                                     if klast >= 0 else 0))
    # the main path's shape: 40 (row, KV head) pairs, 280 CTAs
    if (b, kv, capacity) == (8, 5, 1024):
        assert splits == 7


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mma_bodies_fit_the_shared_memory_a_block_may_use(dtype):
    """Every (head dim, G) the rules send to a tensor-core attention body
    fits its shared memory (the bodies' own formulas, mirrored in the
    wrappers) within the 232,448 bytes a block may use; gemma3-12b's
    hd 256 at the budgets the sources state."""
    dt = getattr(torch, dtype)
    taken = 0
    for hd in range(8, 520, 8):
        if prefill_body(dt, hd) == "mma":
            taken += 1
            assert prefill_smem_bytes(hd) <= SMEM_PER_BLOCK
        for g in range(1, 18):
            if decode_body(dt, hd, g) == "mma":
                taken += 1
                assert decode_smem_bytes(hd, g) <= SMEM_PER_BLOCK
    assert taken == (0 if dtype == "float32" else 9 + 8 * 16 + 8)
    assert prefill_smem_bytes(256) == 168960
    assert prefill_smem_bytes(128) == 156672
    assert decode_smem_bytes(256, 2) == 202752


def _prefill_shares(klast: int, span: int, splits: int) -> list:
    """The steps of ``span`` logical slots [st0, st1) each CTA of a row
    tile's cluster takes when the tile's last key is ``klast``
    (csrc/paged_prefill_attention.cu::mma::prefill_kernel)."""
    nst = klast // span + 1
    per = -(-nst // splits)
    return [(r * per, min(r * per + per, nst)) for r in range(splits)]


def _one_wave_and_most(pairs: int, splits: int, steps: int) -> None:
    """A wide split fits one portable cluster and the capacity's steps,
    its clusters all fit on the card at once (or it is 1), and no larger
    count would."""
    top = min(DECODE_MAX_SPLITS, steps)
    assert 1 <= splits <= top
    assert pairs <= WIDE_CLUSTERS[splits] or splits == 1
    assert all(pairs > WIDE_CLUSTERS[s] for s in range(splits + 1, top + 1))


@pytest.mark.parametrize("c,h,kv,hd,capacity", [
    (128, 16, 8, 256, 2176),     # gemma3-12b's prefill chunk
    (5, 16, 8, 256, 2176),       # a verify round's rows of K + 1 = 5
    (1, 16, 8, 256, 2176), (77, 16, 8, 256, 2176), (128, 32, 8, 256, 4096),
    (128, 4, 4, 256, 48),        # a capacity of one step
    (128, 15, 5, 64, 1024),      # smollm-360m: no split below hd 256
    (40, 16, 2, 128, 64),
])
def test_prefill_splits_cover_the_keys_and_fill_the_card(c, h, kv, hd,
                                                         capacity):
    """The split depends on shapes alone (never on pos or the batch, so a
    batched row matches a one-row call), fills the card in one wave of
    clusters, asks for no more CTAs than the capacity has steps, and its
    shares cover every step of a row tile exactly once at every last key
    (a share past it is empty)."""
    splits = prefill_splits(c, h, kv, hd, capacity)
    if hd <= 128:
        assert splits == 1
        return
    span = prefill_span(hd)
    tiles = -(-c * (h // kv) // PREFILL_ROWS)
    _one_wave_and_most(tiles * kv, splits, -(-capacity // span))
    for klast in range(capacity):
        shares = _prefill_shares(klast, span, splits)
        covered = [st for st0, st1 in shares for st in range(st0, st1)]
        assert covered == list(range(klast // span + 1))
    # gemma3-12b's chunk: 4 row tiles x 8 KV heads x 3 = 96 CTAs
    if (c, h, kv, hd) == (128, 16, 8, 256):
        assert splits == 3


@pytest.mark.parametrize("b,capacity", [(8, 2176), (8, 1024), (1, 2176),
                                        (4, 1024), (32, 2176), (2, 16)])
def test_wide_decode_splits_fill_the_card_in_one_wave(b, capacity):
    """At hd 256 (gemma3-12b's 8 KV heads) the decode split is the most
    whose clusters the card holds at once; its shares cover the slots as
    the narrow split's do."""
    splits = decode_splits(b, 8, capacity, 256)
    _one_wave_and_most(b * 8, splits, -(-capacity // DECODE_CHUNK))
    for klast in range(-1, capacity):
        covered = [ch for c0, c1 in _decode_shares(klast, splits)
                   for ch in range(c0, c1)]
        assert covered == list(range(klast // DECODE_CHUNK + 1
                                     if klast >= 0 else 0))
    # the main path's 8 rows: 64 (row, KV head) pairs, clusters of 2
    if b == 8:
        assert splits == 2


def _chip_smoke():
    """``chip_smoke.py`` (at the repository root) as a module."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("model", ["smollm-360m", "qwen2-72b"])
def test_quant_launches_by_body_follow_the_rows_of_each_forward(fmt, model):
    """``chip_smoke.py``'s count of a packed bf16 serve run's quant
    launches by body: at smollm-360m's int4, each 128-row chunk sends
    the four attention projections of every layer to mma and the rest
    to wgmma, decode iterations and shorter chunks everything to wgmma;
    its int8 is all mma, qwen2-72b's all wgmma.  The bodies sum to the
    run's launches, and forwards that do not add up are refused."""
    from repro_torch.configs import get_config
    cs = _chip_smoke()
    cfg = get_config(model)
    layers = cfg.block_pattern.count("attn")
    rows = collections.Counter({8: 40, 3: 4, 128: 5, 64: 2, 16: 1})
    expect, by_body = cs.expected_launches(
        cfg, False, fmt, 44, 8, _build.launches, rows=rows)
    total = expect[f"quant_matmul_{fmt}"]
    assert total == 7 * layers * 52
    got = by_body[f"quant_matmul_{fmt}"]
    assert sum(got.values()) == total and got["cuda_core"] == 0
    want_mma = (total if (model, fmt) == ("smollm-360m", "int8")
                else 4 * layers * 5 if model == "smollm-360m" else 0)
    assert got["mma"] == want_mma and got["wgmma"] == total - want_mma
    assert set(cs.main_bodies(cfg)[f"quant_matmul_{fmt}"]) == set(
        cs.QUANT_BODY[model][f"quant_matmul_{fmt}"])
    with pytest.raises(AssertionError):
        cs.expected_launches(cfg, False, fmt, 44, 9, _build.launches,
                             rows=rows)


def test_timed_engine_counts_the_rows_of_each_forward(monkeypatch):
    """``chip_smoke.py``'s timed engine records the rows of x of every
    forward, which the quant count by body reads: each prefill chunk's
    tokens (``chunk_sizes``' pieces) and each decode iteration's rows,
    as many forwards as the engine ran (a small paged engine on the
    CPU)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.engine import (PagedServingEngine, Request,
                                            chunk_sizes)
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cfg = get_smoke_config("smollm-360m")
    eng = cs._timed(PagedServingEngine)(
        cfg, seed=3, max_rows=3, max_len=64, block_size=8, prefill_chunk=8,
        decode_steps=2, device="cpu")
    prompts = [[1 + i % 50 for i in range(n)] for n in (19, 8, 5)]
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new_tokens=5))
    eng.run()
    rows = eng.forward_rows
    assert sum(rows.values()) == eng.decode_iters + eng.prefill_calls
    chunks = collections.Counter(c for p in prompts
                                 for c in chunk_sizes(len(p) - 1, 8))
    assert eng.prefill_calls == sum(chunks.values())
    for c, n in chunks.items():
        assert rows[c] >= n
    assert rows[3] >= eng.decode_iters        # every row of the batch


@pytest.mark.parametrize("sms,clusters,named", [
    (132, {}, []),                                   # the H100 SXM
    (114, {}, ["decode_attention.SM_COUNT: expected 132, got 114",
               "selective_scan.SM_COUNT"]),
    (132, {3: 33, 8: 16}, [
        "WIDE_CLUSTERS[3] at paged_prefill_attention's 168960 B: "
        "expected 39, got 33", "WIDE_CLUSTERS[8] at ring_chunk_attention's",
        "WIDE_CLUSTERS[3] at paged_decode_attention's 202752 B",
        "WIDE_CLUSTERS[3] at paged_prefill_attention wgmma hd 128's "
        "165120 B: expected 39, got 33",
        "WIDE_CLUSTERS[8] at ring_chunk_attention wgmma hd 64's 83200 B"]),
])
def test_device_tables_fail_by_name(monkeypatch, sms, clusters, named):
    """``chip_smoke.py``'s device phase holds the card's SM count and
    cluster capacity against the constants the split rules read, and on
    a mismatch fails naming the table, the size, and both values (the
    card's answers stood in for here)."""
    cs = _chip_smoke()
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import launch_floor
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=sms))
    monkeypatch.setattr(launch_floor, "max_active_clusters",
                        lambda sp, threads, smem: clusters.get(
                            sp, WIDE_CLUSTERS[sp]))
    monkeypatch.setattr(flash_mod, "cross_wgmma_clusters",
                        lambda hd, sp: clusters.get(sp, WIDE_CLUSTERS[sp]))
    monkeypatch.setattr(flash_mod, "chunk_wgmma_clusters",
                        lambda hd, sp, form="chunk": clusters.get(
                            sp, WIDE_CLUSTERS[sp]))
    monkeypatch.setattr(flash_mod, "wgmma_occupancy",
                        lambda hd=64, form="flash": (
                            flash_mod.WGMMA_CTAS_PER_SM,
                            flash_mod.wgmma_smem_bytes(hd, form),
                            flash_mod.wgmma_tile_keys(hd, form)))
    _quant_tables_as_mirrored(monkeypatch)
    monkeypatch.setattr(cs, "emit", lambda obj: None)
    if not named:
        assert cs.device_tables("cpu")["mismatches"] == []
        return
    with pytest.raises(AssertionError) as err:
        cs.device_tables("cpu")
    for text in named:
        assert text in str(err.value)


@pytest.mark.parametrize("ctas,smem,keys,named", [
    (0, 115968, 128, ["WGMMA_CTAS_PER_SM at the wgmma body's 115968 B: "
                      "expected 1, got 0"]),
    (2, 99328, 128, ["WGMMA_CTAS_PER_SM at the wgmma body's 99328 B: "
                     "expected 1, got 2"]),
    (1, 99328, 128, ["wgmma_smem_bytes(64, 'flash'): expected 115968, "
                     "the kernel has 99328",
                     "wgmma_smem_bytes(112, 'flash'): expected 165120",
                     "wgmma_smem_bytes(128, 'cross'): expected 165120",
                     "wgmma_smem_bytes(112, 'chunk'): expected 165120",
                     "wgmma_smem_bytes(64, 'ring'): expected 83200"]),
    (1, 115968, 32, ["wgmma_tile_keys(64, 'flash'): expected 128, the "
                     "kernel has 32",
                     "wgmma_tile_keys(112, 'flash'): expected 64, the "
                     "kernel has 32",
                     "wgmma_tile_keys(64, 'cross'): expected 64, the "
                     "kernel has 32",
                     "wgmma_tile_keys(112, 'ring'): expected 64, the "
                     "kernel has 32"]),
])
def test_device_tables_name_the_wgmma_body(monkeypatch, ctas, smem, keys,
                                           named):
    """The device phase holds the wgmma bodies' CTAs an SM (the occupancy
    calculator on each kernel, the contiguous form at hd 64, 112 and 128,
    the cross form at 64 and 128 and the paged chunk's and the window
    form's at 64, 112 and 128, at the shared memory the kernel reports)
    against
    ``WGMMA_CTAS_PER_SM``, and that shared memory and the keys of a K/V
    tile against their Python mirrors, and fails naming the mirror or
    the shared memory and both values."""
    cs = _chip_smoke()
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import launch_floor
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(launch_floor, "max_active_clusters",
                        lambda sp, threads, smem: WIDE_CLUSTERS[sp])
    monkeypatch.setattr(flash_mod, "cross_wgmma_clusters",
                        lambda hd, sp: WIDE_CLUSTERS[sp])
    monkeypatch.setattr(flash_mod, "chunk_wgmma_clusters",
                        lambda hd, sp, form="chunk": WIDE_CLUSTERS[sp])
    monkeypatch.setattr(flash_mod, "wgmma_occupancy",
                        lambda hd=64, form="flash": (ctas, smem, keys))
    _quant_tables_as_mirrored(monkeypatch)
    monkeypatch.setattr(cs, "emit", lambda obj: None)
    with pytest.raises(AssertionError) as err:
        cs.device_tables("cpu")
    for text in named:
        assert text in str(err.value)


def _quant_tables_as_mirrored(monkeypatch, ctas=None, smem_off=0,
                              stages_off=0, clusters=None):
    """The card's answers for the quant matmul's wgmma body stood in by
    its Python mirrors (``ctas`` CTAs an SM, the shared memory and stages
    moved by the offsets, ``clusters`` replacing table entries where
    given)."""
    monkeypatch.setattr(qmm_mod, "wgmma_occupancy", lambda fmt, rows: (
        qmm_mod.wgmma_ctas_per_sm(rows) if ctas is None else ctas,
        qmm_mod.wgmma_smem_bytes(fmt, rows) + smem_off,
        wgmma_stages(fmt, rows) + stages_off))
    monkeypatch.setattr(qmm_mod, "wgmma_clusters", lambda fmt, rows, sp: (
        clusters or {}).get(sp, WGMMA_CLUSTERS[wgmma_ctas_per_sm(rows)][sp]))


@pytest.mark.parametrize("kw,named", [
    ({}, []),
    ({"ctas": 1}, ["quant_matmul.wgmma_ctas_per_sm('int8', 8): expected 2, "
                   "the kernel has 1",
                   "quant_matmul.wgmma_ctas_per_sm('int4', 16)"]),
    ({"smem_off": 1024}, ["quant_matmul.wgmma_smem_bytes('int4', 128): "
                          "expected 226560, the kernel has 227584"]),
    ({"stages_off": -1}, ["quant_matmul.wgmma_stages('int8', 128): expected "
                          "9, the kernel has 8"]),
    ({"clusters": {5: 40}}, ["quant_matmul.WGMMA_CLUSTERS[2][5] at int8 rows "
                             "8: expected 47, got 40",
                             "quant_matmul.WGMMA_CLUSTERS[1][5] at int4 rows "
                             "128: expected 22, got 40"]),
])
def test_device_tables_hold_the_quant_wgmma_mirrors(monkeypatch, kw, named):
    """The device phase holds the quant matmul's wgmma body at every rows
    of x it takes (both formats): its CTAs an SM, shared memory and
    stages against the mirrors the split rule reads, and its clusters of
    1-8 CTAs against ``WGMMA_CLUSTERS``, and fails naming the mirror, the
    shape and both values before any kernel phase."""
    cs = _chip_smoke()
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import launch_floor
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(launch_floor, "max_active_clusters",
                        lambda sp, threads, smem: WIDE_CLUSTERS[sp])
    monkeypatch.setattr(flash_mod, "cross_wgmma_clusters",
                        lambda hd, sp: WIDE_CLUSTERS[sp])
    monkeypatch.setattr(flash_mod, "chunk_wgmma_clusters",
                        lambda hd, sp, form="chunk": WIDE_CLUSTERS[sp])
    monkeypatch.setattr(flash_mod, "wgmma_occupancy",
                        lambda hd=64, form="flash": (
                            flash_mod.WGMMA_CTAS_PER_SM,
                            flash_mod.wgmma_smem_bytes(hd, form),
                            flash_mod.wgmma_tile_keys(hd, form)))
    _quant_tables_as_mirrored(monkeypatch, **kw)
    monkeypatch.setattr(cs, "emit", lambda obj: None)
    if not named:
        res = cs.device_tables("cpu")
        assert res["mismatches"] == []
        assert len(res["quant_wgmma"]) == 10
        return
    with pytest.raises(AssertionError) as err:
        cs.device_tables("cpu")
    for text in named:
        assert text in str(err.value)


@pytest.mark.parametrize("stores,loads", [(0, 0), (68, 100)])
def test_wgmma_ptxas_reads_each_instantiation(stores, loads):
    """The build line's reading of ptxas's report: the wgmma body's entry
    with its launch registers and spilled bytes (stores and loads), other
    kernels (which may spill) left out."""
    cs = _chip_smoke()
    report = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_12wg18flash_wgmma_kernelE14CUtensorMap_st' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN2wg18flash_wgmma",
        f"    48 bytes stack frame, {stores} bytes spill stores, {loads} "
        f"bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN3mma16flash_mma_kernel'"
        " for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 136 registers"])
    got = cs.wgmma_ptxas(report)
    assert got == [
        {"entry": "_ZN12_GLOBAL__N_12wg18flash_wgmma_kernelE14CUtensorMap_st",
         "spill_bytes": stores + loads, "registers_at_launch": 168}]


# ----------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_matches_plain(cuda_device, dtype):
    """The norm body (every norm without a delta), and the previous
    cuda_core body forced, each counted once under its body."""
    rng = np.random.default_rng(8)
    dt = getattr(torch, dtype)
    for rows, d in ((8, 960), (128, 960), (8, 3840), (5, 100)):
        x = t(rng.standard_normal((rows, d), dtype=np.float32)).to(cuda_device, dt)
        s = t(rng.standard_normal(d, dtype=np.float32)).to(cuda_device, dt)
        n0 = _build.launches["rmsnorm"]
        by0 = dict(_build.bodies["rmsnorm"])
        got = rmsnorm(x, s, 1e-5)
        assert _build.launches["rmsnorm"] == n0 + 1
        assert _build.bodies["rmsnorm"] == {
            k: v + (k == "norm") for k, v in by0.items()}
        _card_close(rmsnorm(x, s, 1e-5, _body="cuda_core"),
                    rmsnorm_plain(x, s, 1e-5), dtype)
        assert _build.bodies["rmsnorm"]["cuda_core"] == by0["cuda_core"] + 1
        assert got.dtype == dt
        _card_close(got, rmsnorm_plain(x, s, 1e-5), dtype)


# the kernels phase's shapes (gemma3-12b's 3840: a partial second
# 16-byte access a lane), ragged widths, and one-warp rows 4 a block
ADD_NORM_CARD_SHAPES = [(8, 960), (128, 960), (8, 4096), (128, 4096),
                        (8, 3840), (128, 3840), (5, 100), (3, 3000),
                        (1000, 128)]


def _card_norm_inputs(cuda_device, rng, rows, d, dt, offset):
    """x, delta, scale on the card; ``offset`` 1 puts each one element
    into its buffer, off 16-byte alignment, which takes the kernel's
    one-element accesses."""
    def card(a):
        buf = torch.empty(a.size + offset, dtype=dt, device=cuda_device)
        view = buf[offset:].view(a.shape)
        view.copy_(t(a).to(cuda_device))
        return view
    return (card(rng.standard_normal((rows, d), dtype=np.float32)),
            card(rng.standard_normal((rows, d), dtype=np.float32)),
            card((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", ADD_NORM_CARD_SHAPES)
def test_cuda_add_rmsnorm_matches_plain(cuda_device, rows, d, dtype,
                                        offset):
    """The add_norm body: ``r`` bit-equal to torch's ``x + delta``,
    ``out`` within the card gate of the plain version, repeated calls
    bit-equal, one launch counted under add_norm; the previous
    composition (torch's add, then the cuda_core norm) under the same
    gate, counted under cuda_core."""
    rng = np.random.default_rng(9)
    dt = getattr(torch, dtype)
    x, dl, sc = _card_norm_inputs(cuda_device, rng, rows, d, dt, offset)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    n0 = _build.launches["rmsnorm"]
    by0 = dict(_build.bodies["rmsnorm"])
    r, out = add_rmsnorm(x, dl, sc, 1e-5)
    assert _build.launches["rmsnorm"] == n0 + 1
    assert _build.bodies["rmsnorm"] == {
        k: v + (k == "add_norm") for k, v in by0.items()}
    assert r.dtype == out.dtype == dt
    assert torch.equal(r, x + dl)
    want = add_rmsnorm_plain(x, dl, sc, 1e-5)[1]
    _card_close(out, want, dtype)
    for _ in range(3):
        r2, out2 = add_rmsnorm(x, dl, sc, 1e-5)
        assert torch.equal(r2, r) and torch.equal(out2, out)
    rp, outp = add_rmsnorm(x, dl, sc, 1e-5, _body="cuda_core")
    assert _build.bodies["rmsnorm"]["cuda_core"] == by0["cuda_core"] + 1
    assert torch.equal(rp, r)
    _card_close(outp, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,rpb", [(32, 1), (32, 2), (32, 8), (64, 1),
                                       (128, 1), (256, 1)])
@pytest.mark.parametrize("rows,d,dtype", [(8, 960, "float32"),
                                          (8, 960, "bfloat16"),
                                          (128, 4096, "bfloat16")])
def test_cuda_add_rmsnorm_any_launch_shape(cuda_device, monkeypatch, rows,
                                           d, dtype, lanes, rpb):
    """Every launch shape the kernel takes (one warp a row with up to 16
    accesses a lane, 1 to 8 rows a block, shuffles only; or 2 to 8 warps
    a row with the shared-memory exchange and its barrier) gives the
    same r and, within the gate, the same out as the rule's; norm and
    add_norm alike."""
    rng = np.random.default_rng(10)
    dt = getattr(torch, dtype)
    x, dl, sc = _card_norm_inputs(cuda_device, rng, rows, d, dt, 0)
    r1, out1 = add_rmsnorm(x, dl, sc, 1e-5)
    n1 = rmsnorm(x, sc, 1e-5)
    n_acc = d // norm_pack(dt, d)
    vecs = next(v for v in NORM_VECS if v * lanes >= n_acc)
    monkeypatch.setattr(norm_mod, "norm_lanes",
                        lambda *a: (lanes, rpb, vecs))
    r, out = add_rmsnorm(x, dl, sc, 1e-5)
    assert torch.equal(r, r1)
    _card_close(out, out1, dtype)
    _card_close(rmsnorm(x, sc, 1e-5), n1, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,nb,bs,d", [
    (8, 15, 5, 64, 16, 64),   # smollm-360m decode
    (3, 6, 2, 3, 8, 32),
    (2, 16, 2, 4, 16, 128),   # G = 8, hd 128: over 48 KB of shared memory
    (8, 32, 32, 136, 16, 112),   # zamba2-7b decode: MHA, hd 112
])
def test_cuda_paged_decode_matches_plain(cuda_device, dtype, b, h, kv, nb,
                                         bs, d):
    rng = np.random.default_rng(9)
    q, kp, vp, tables, pos = _paged_inputs(rng, b, h, kv, nb, bs, d)
    tables[-1] = 0          # a masked row against the scratch block
    dt = getattr(torch, dtype)
    args = [t(a).to(cuda_device, dt) for a in (q, kp, vp)] + [
        t(a).to(cuda_device) for a in (tables, pos)]
    _card_close(paged_decode_attention(*args),
                paged_decode_attention_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,pos,d", [(128, 0, 64), (128, 256, 64),
                                     (7, 3, 64), (33, 40, 64),
                                     (40, 9, 128),    # hd 128: > 48 KB smem
                                     (1, 0, 64), (1, 200, 64),   # ragged C
                                     (77, 0, 64), (77, 300, 64),
                                     (100, 450, 64),  # pos + C > max_len
                                     (5, 7, 72),      # hd off the mma tiles
                                     (128, 300, 112)])   # zamba2-7b's hd
def test_cuda_paged_prefill_matches_plain(cuda_device, dtype, c, pos, d):
    rng = np.random.default_rng(10)
    h, kv, bs, nb = 15, 5, 16, 32
    q = rng.standard_normal((c, h, d), dtype=np.float32)
    kp = rng.standard_normal((nb + 1, bs, kv, d), dtype=np.float32)
    vp = rng.standard_normal((nb + 1, bs, kv, d), dtype=np.float32)
    table = (rng.permutation(nb) + 1).astype(np.int32)
    dt = getattr(torch, dtype)
    args = [t(a).to(cuda_device, dt) for a in (q, kp, vp)] + [
        t(table).to(cuda_device)]
    body = chunk_body(dt, d)
    n0 = _build.bodies["paged_prefill_attention"][body]
    got = paged_prefill_attention(*args, pos)
    assert _build.bodies["paged_prefill_attention"][body] == n0 + 1
    _card_close(got, paged_prefill_attention_plain(*args, pos), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("c,pos", [(128, 0), (128, 256), (77, 300)])
def test_cuda_paged_prefill_cuda_core_body_in_bf16(cuda_device, c, pos):
    """The CUDA-core body, forced on a bf16 main-path shape (as
    chip_smoke.py times it against the mma body), agrees with the plain
    version too."""
    rng = np.random.default_rng(19)
    h, kv, bs, nb, d = 15, 5, 16, 32, 64
    q = rng.standard_normal((c, h, d), dtype=np.float32)
    kp = rng.standard_normal((nb + 1, bs, kv, d), dtype=np.float32)
    vp = rng.standard_normal((nb + 1, bs, kv, d), dtype=np.float32)
    table = (rng.permutation(nb) + 1).astype(np.int32)
    args = [t(a).to(cuda_device, torch.bfloat16) for a in (q, kp, vp)] + [
        t(table).to(cuda_device)]
    n0 = _build.bodies["paged_prefill_attention"]["cuda_core"]
    got = paged_prefill_attention(*args, pos, _body="cuda_core")
    assert _build.bodies["paged_prefill_attention"]["cuda_core"] == n0 + 1
    _card_close(got, paged_prefill_attention_plain(*args, pos), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,pos", [(128, 0), (128, 256), (77, 300),
                                   (100, 450)])
def test_cuda_paged_prefill_bits_do_not_depend_on_blocks(cuda_device, dtype,
                                                         c, pos):
    """The same logical K/V as a shuffled table of 16-slot blocks and as
    one block of all the slots (the slot engine's dense row) gives the
    same bits."""
    rng = np.random.default_rng(20)
    h, kv, bs, nb, d = 15, 5, 16, 32, 64
    q = rng.standard_normal((c, h, d), dtype=np.float32)
    k = rng.standard_normal((nb * bs, kv, d), dtype=np.float32)
    v = rng.standard_normal((nb * bs, kv, d), dtype=np.float32)
    table = rng.permutation(nb).astype(np.int32) + 1
    kp = np.zeros((nb + 1, bs, kv, d), np.float32)
    vp = np.zeros((nb + 1, bs, kv, d), np.float32)
    kp[table] = k.reshape(nb, bs, kv, d)
    vp[table] = v.reshape(nb, bs, kv, d)
    dt = getattr(torch, dtype)

    def card(a):
        return t(a).to(cuda_device, dt)
    paged = paged_prefill_attention(card(q), card(kp), card(vp),
                                    t(table).to(cuda_device), pos)
    dense = paged_prefill_attention(
        card(q), card(k[None]), card(v[None]),
        torch.zeros(1, dtype=torch.int32, device=cuda_device), pos)
    assert torch.equal(paged, dense)


def _chunk_card_inputs(rng, b, c, h, kv, d, bs, nb, pos):
    """The batched paged-chunk form's inputs: q (B,C,H,D), pools of
    ``b * nb + 1`` blocks of ``bs``, distinct shuffled tables over blocks
    1.., and each row's pos.  Row 0's blocks do not cover its pos + C:
    from the block of its last query on, its table points at the scratch
    block 0, which it reads as the reference does."""
    nbp = b * nb + 1
    q = rng.standard_normal((b, c, h, d), dtype=np.float32)
    kp = rng.standard_normal((nbp, bs, kv, d), dtype=np.float32)
    vp = rng.standard_normal((nbp, bs, kv, d), dtype=np.float32)
    tables = (rng.permutation(nbp - 1)[:b * nb].reshape(b, nb) + 1
              ).astype(np.int32)
    tables[0, min(pos[0] + c - 1, nb * bs - 1) // bs:] = 0
    return q, kp, vp, tables, np.asarray(pos, np.int32)


#: the verify round's shapes on smollm-360m (B 8, C = K + 1 = 5, H 15,
#: KV 5, hd 64, blocks of 16 of a 1024-slot row) with pos spread over
#: 32-600 (and 1021: pos + C past max_len, clamped), a ragged chunk,
#: and a head dim off the mma tiles
CHUNK_CASES = [(8, 5, 15, 5, 64, [32, 600, 117, 256, 5, 1021, 400, 63]),
               (3, 9, 6, 2, 32, [0, 77, 300]),
               (2, 5, 15, 5, 72, [40, 500]),
               # qwen2-72b's verify round: 64 / 8 heads of 128 (G 8)
               (8, 5, 64, 8, 128, [32, 600, 117, 256, 75, 413, 519, 188])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c,h,kv,d,pos", CHUNK_CASES)
def test_cuda_paged_chunk_matches_plain_and_one_row_calls(
        cuda_device, dtype, b, c, h, kv, d, pos):
    """The batched form against its plain version under the card's gates,
    and each row bit-equal to a one-row call at its pos (the same
    instructions run for it); pos stays on the device."""
    rng = np.random.default_rng(31)
    q, kp, vp, tables, pos = _chunk_card_inputs(rng, b, c, h, kv, d, 16, 64,
                                                pos)
    dt = getattr(torch, dtype)
    args = [t(a).to(cuda_device, dt) for a in (q, kp, vp)] + [
        t(a).to(cuda_device) for a in (tables, pos)]
    body = chunk_body(dt, d)
    n0 = _build.bodies["paged_chunk_attention"][body]
    got = paged_chunk_attention(*args)
    assert _build.bodies["paged_chunk_attention"][body] == n0 + 1
    assert bool(torch.isfinite(got).all())
    _card_close(got, paged_chunk_attention_plain(*args), dtype)
    for row in range(b):
        one = paged_prefill_attention(args[0][row].contiguous(), args[1],
                                      args[2], args[3][row].contiguous(),
                                      int(pos[row]))
        assert torch.equal(got[row], one)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_chunk_bits_do_not_depend_on_blocks(cuda_device, dtype):
    """The same logical K/V in blocks of 16 and of 32 slots, and as a
    dense cache (B blocks of S slots, the slot engine's verify round),
    gives the same bits."""
    rng = np.random.default_rng(32)
    b, c, h, kv, d, s = 8, 5, 15, 5, 64, 1024
    pos = np.array([32, 600, 117, 256, 5, 1021, 400, 63], np.int32)
    q = rng.standard_normal((b, c, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    dt = getattr(torch, dtype)
    outs = []
    for bs in (16, 32):
        nb = s // bs
        tables = (rng.permutation(b * nb).reshape(b, nb) + 1).astype(np.int32)
        kp = np.zeros((b * nb + 1, bs, kv, d), np.float32)
        vp = np.zeros((b * nb + 1, bs, kv, d), np.float32)
        kp[tables] = k.reshape(b, nb, bs, kv, d)
        vp[tables] = v.reshape(b, nb, bs, kv, d)
        outs.append(paged_chunk_attention(
            *[t(a).to(cuda_device, dt) for a in (q, kp, vp)],
            *[t(a).to(cuda_device) for a in (tables, pos)]))
    outs.append(paged_chunk_attention(
        *[t(a).to(cuda_device, dt) for a in (q, k, v)],
        torch.arange(b, dtype=torch.int32, device=cuda_device)[:, None],
        t(pos).to(cuda_device)))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.cuda
def test_cuda_paged_chunk_cuda_core_body_in_bf16(cuda_device):
    """The CUDA-core body forced on the bf16 verify shape (chip_smoke.py
    times it against the mma body) agrees with the plain version too."""
    rng = np.random.default_rng(33)
    b, c, h, kv, d, pos = CHUNK_CASES[0]
    q, kp, vp, tables, pos = _chunk_card_inputs(rng, b, c, h, kv, d, 16, 64,
                                                pos)
    args = [t(a).to(cuda_device, torch.bfloat16) for a in (q, kp, vp)] + [
        t(a).to(cuda_device) for a in (tables, pos)]
    n0 = _build.bodies["paged_chunk_attention"]["cuda_core"]
    got = paged_chunk_attention(*args, _body="cuda_core")
    assert _build.bodies["paged_chunk_attention"]["cuda_core"] == n0 + 1
    _card_close(got, paged_chunk_attention_plain(*args), "bfloat16")


#: the paged chunk's wgmma body on the card (C, H, KV, hd, pos, capacity):
#: smollm-360m's chunk (G 3, hd 64), zamba2-7b's (hd 112, G 1), the hd-128
#: G-8 chunk, a ragged chunk at hd 112, one query, a chunk whose last
#: queries pass the capacity (the clamp), a chunk at pos 0 of G 1
CHUNK_WGMMA_CASES = [(128, 15, 5, 64, 256, 1024),
                     (128, 32, 32, 112, 2048, 2176),
                     (128, 64, 8, 128, 1024, 1152),
                     (77, 6, 2, 112, 300, 512), (1, 15, 5, 64, 200, 512),
                     (100, 15, 5, 64, 450, 512), (128, 16, 16, 64, 0, 1024)]


def _chunk_wgmma_inputs(rng, c, h, kv, d, capacity, bs=16):
    """q (C,H,D); the capacity's K and V in logical order; pools of blocks
    of ``bs`` through a shuffled table over blocks 1.. (block 0 the
    scratch block)."""
    nb = -(-capacity // bs)
    q = rng.standard_normal((c, h, d), dtype=np.float32)
    k = rng.standard_normal((nb * bs, kv, d), dtype=np.float32)
    v = rng.standard_normal((nb * bs, kv, d), dtype=np.float32)
    table = (rng.permutation(nb) + 1).astype(np.int32)
    kp = np.zeros((nb + 1, bs, kv, d), np.float32)
    vp = np.zeros((nb + 1, bs, kv, d), np.float32)
    kp[table] = k.reshape(nb, bs, kv, d)
    vp[table] = v.reshape(nb, bs, kv, d)
    return q, k, v, kp, vp, table


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,kv,d,pos,capacity", CHUNK_WGMMA_CASES)
def test_cuda_chunk_wgmma_matches_plain_and_mma(cuda_device, c, h, kv, d,
                                                pos, capacity):
    """The paged chunk's wgmma body (bf16; the rule's at these shapes)
    against its plain version under the card's gates, and against the
    ``mma`` body forced on the same inputs (as chip_smoke.py times them
    in turns); one launch counted on each."""
    rng = np.random.default_rng(40 + d)
    q, _, _, kp, vp, table = _chunk_wgmma_inputs(rng, c, h, kv, d, capacity)
    bf = torch.bfloat16
    args = [t(a).to(cuda_device, bf) for a in (q, kp, vp)] + [
        t(table).to(cuda_device)]
    assert chunk_body(bf, d) == "wgmma"
    n0 = dict(_build.bodies["paged_prefill_attention"])
    got = paged_prefill_attention(*args, pos)
    mma = paged_prefill_attention(*args, pos, _body="mma")
    assert _build.bodies["paged_prefill_attention"] == {
        "wgmma": n0["wgmma"] + 1, "mma": n0["mma"] + 1,
        "cuda_core": n0["cuda_core"]}
    assert bool(torch.isfinite(got.float()).all())
    _card_close(got, paged_prefill_attention_plain(*args, pos), "bfloat16")
    _card_close(got, mma, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("d", CHUNK_WGMMA_HD)
def test_cuda_chunk_wgmma_bits(cuda_device, d):
    """On the paged chunk's wgmma body the same logical K/V in blocks of
    16, of 32 and as one dense block gives the same bits; so do each row
    of a batched launch (pos on the device) and a one-row call at its
    pos, and a batched launch of one row against the host-pos call."""
    rng = np.random.default_rng(50 + d)
    b, c, h, kv, s = 4, 128, 16, 4, 1024
    pos = np.array([0, 300, 896, 517], np.int32)
    q = rng.standard_normal((b, c, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    bf = torch.bfloat16
    qd = t(q).to(cuda_device, bf)
    pos_d = t(pos).to(cuda_device)
    outs = []
    for bs in (16, 32):
        nb = s // bs
        tables = (rng.permutation(b * nb).reshape(b, nb) + 1).astype(np.int32)
        kp = np.zeros((b * nb + 1, bs, kv, d), np.float32)
        vp = np.zeros((b * nb + 1, bs, kv, d), np.float32)
        kp[tables] = k.reshape(b, nb, bs, kv, d)
        vp[tables] = v.reshape(b, nb, bs, kv, d)
        pools = [t(a).to(cuda_device, bf) for a in (kp, vp)]
        tables_d = t(tables).to(cuda_device)
        outs.append(paged_chunk_attention(qd, *pools, tables_d, pos_d))
        if bs == 16:
            for row in range(b):
                one = paged_prefill_attention(
                    qd[row].contiguous(), *pools,
                    tables_d[row].contiguous(), int(pos[row]))
                assert torch.equal(outs[0][row], one)
                one_dev = paged_chunk_attention(
                    qd[row:row + 1].contiguous(), *pools,
                    tables_d[row:row + 1].contiguous(), pos_d[row:row + 1])
                assert torch.equal(one_dev[0], one)
    outs.append(paged_chunk_attention(
        qd, *[t(a).to(cuda_device, bf) for a in (k, v)],
        torch.arange(b, dtype=torch.int32, device=cuda_device)[:, None],
        pos_d))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    _card_close(outs[0], paged_chunk_attention_plain(
        qd, *[t(a).to(cuda_device, bf) for a in (k, v)],
        torch.arange(b, dtype=torch.int32, device=cuda_device)[:, None],
        pos_d), "bfloat16")


@pytest.mark.cuda
def test_cuda_chunk_wgmma_refuses_what_it_cannot_take(cuda_device):
    """The wgmma body forced at a head dim it has no body for, in float32,
    or over blocks that do not cut into 8-slot segments raises; no
    fallback runs."""
    rng = np.random.default_rng(60)

    def args(d, dt, bs=16):
        q, _, _, kp, vp, table = _chunk_wgmma_inputs(rng, 8, 4, 2, d, 64, bs)
        return [t(a).to(cuda_device, dt) for a in (q, kp, vp)] + [
            t(table).to(cuda_device)]
    for a in (args(96, torch.bfloat16), args(64, torch.float32),
              args(64, torch.bfloat16, bs=4)):
        with pytest.raises(RuntimeError):
            paged_prefill_attention(*a, 5, _body="wgmma")
    q, kp, vp, table = args(96, torch.bfloat16)
    kn = torch.zeros((8, 2, 96), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(RuntimeError):
        ring_chunk_attention(q, kp, vp, table, kn, kn, 5, 32, _body="wgmma")


#: the window form's wgmma body on the card (pos, C, H, KV, hd, w):
#: mixtral-8x7b's chunk before, inside and past the wrap of its 4096-slot
#: ring; a chunk longer than the ring; hd 112 on a ragged ring; a short
#: chunk; a chunk longer than a small ring at hd 128
RING_WGMMA_CASES = [(0, 128, 32, 8, 128, 4096), (2048, 128, 32, 8, 128, 4096),
                    (4300, 128, 32, 8, 128, 4096), (45, 64, 6, 2, 64, 32),
                    (100, 33, 4, 4, 112, 48), (7, 5, 6, 2, 64, 32),
                    (300, 160, 16, 8, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("pos,c,h,kv,d,w", RING_WGMMA_CASES)
def test_cuda_ring_wgmma_matches_plain_and_mma(cuda_device, pos, c, h, kv,
                                               d, w):
    """The window form's wgmma body (bf16; ``ring_body``'s at these
    shapes) against its plain version under the card's gates and against
    the ``mma`` body forced on the same inputs; the same ring in blocks
    of 32 and as one dense block of w slots gives the bits of blocks of
    16, and so does pos as a (1,) int32 tensor on the card."""
    bf = torch.bfloat16
    args, ring = _ring_card_args(cuda_device, bf, pos, c, h, kv, d, w)
    assert ring_body(bf, d) == "wgmma"
    n0 = dict(_build.bodies["ring_chunk_attention"])
    got = ring_chunk_attention(*args)
    mma = ring_chunk_attention(*args, _body="mma")
    assert _build.bodies["ring_chunk_attention"] == {
        "wgmma": n0["wgmma"] + 1, "mma": n0["mma"] + 1,
        "cuda_core": n0["cuda_core"]}
    assert bool(torch.isfinite(got.float()).all())
    _card_close(got, ring_chunk_attention_plain(*args), "bfloat16")
    _card_close(got, mma, "bfloat16")
    nb32 = -(-w // 32)
    pools32 = []
    for r in ring:
        pool = torch.zeros((nb32 + 1, 32, kv, d))
        pool[1:].reshape(-1, kv, d)[:w] = r
        pools32.append(pool.to(cuda_device, bf))
    table32 = torch.arange(1, nb32 + 1, dtype=torch.int32, device=cuda_device)
    assert torch.equal(got, ring_chunk_attention(
        args[0], *pools32, table32, *args[4:]))
    dense = [r[None].to(cuda_device, bf) for r in ring]
    assert torch.equal(got, ring_chunk_attention(
        args[0], *dense, torch.zeros(1, dtype=torch.int32,
                                     device=cuda_device), *args[4:]))
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda_device)
    assert torch.equal(got, ring_chunk_attention(*args[:6], pos_t, w))


#: the cross form's shapes (B, C, H, KV, hd, src): seamless-m4t-medium's
#: enc_xattn (16 / 16 heads of 64 over the encoder's 1024 frames) and
#: llama-3.2-vision-90b's xattn (64 / 8 heads of 128 over 1601 image
#: patches, 1601 = 100 x 16 + 1: the last tile's tail masked), as a
#: chunk (B 1, C 128) and as Model.prefill's rows (B 8); a ragged case
#: off the tiles
CROSS_CASES = [(1, 128, 16, 16, 64, 1024), (8, 128, 16, 16, 64, 1024),
               (1, 128, 64, 8, 128, 1601), (8, 32, 64, 8, 128, 1601),
               (3, 9, 6, 2, 32, 37)]


def _cross_card_inputs(rng, b, c, h, kv, d, src, bs, dt, dev):
    """q, pools of ceil(src / bs) blocks a row under shuffled tables, and
    the same K/V as a dense cache (B, src, KV, hd), on the card."""
    nb = -(-src // bs)
    nbp = b * nb + 1
    q = rng.standard_normal((b, c, h, d), dtype=np.float32)
    k = rng.standard_normal((b, src, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, src, kv, d), dtype=np.float32)
    tables = (rng.permutation(nbp - 1)[:b * nb].reshape(b, nb) + 1
              ).astype(np.int32)
    pools = []
    for a in (k, v):
        rows = np.zeros((b, nb * bs, kv, d), np.float32)
        rows[:, :src] = a
        pool = np.zeros((nbp, bs, kv, d), np.float32)
        pool[tables] = rows.reshape(b, nb, bs, kv, d)
        pools.append(pool)

    def card(a):
        return t(a).to(dev, dt)
    return (card(q), card(pools[0]), card(pools[1]), t(tables).to(dev),
            card(k), card(v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c,h,kv,d,src", CROSS_CASES)
def test_cuda_paged_cross_matches_plain(cuda_device, dtype, b, c, h, kv, d,
                                        src):
    """The cross form against its plain version under the card's gates,
    counted once under ``cross_body``'s body (bf16: ``wgmma`` at the four
    served shapes, ``mma`` at the ragged one); the same bits over the
    K/V as a dense cache (B blocks of src slots through identity tables,
    ``Model.prefill``'s layout) and in blocks of 32 as in blocks of 16."""
    dt = getattr(torch, dtype)
    q, kp, vp, tables, kd, vd = _cross_card_inputs(
        np.random.default_rng(41), b, c, h, kv, d, src, 16, dt, cuda_device)
    body = cross_body(dt, d)
    assert body == ("cuda_core" if dtype == "float32"
                    else "wgmma" if d in (64, 128) else "mma")
    n0 = _build.bodies["paged_cross_attention"][body]
    got = paged_cross_attention(q, kp, vp, tables, src)
    assert _build.bodies["paged_cross_attention"][body] == n0 + 1
    assert bool(torch.isfinite(got).all())
    _card_close(got, paged_cross_attention_plain(q, kp, vp, tables, src),
                dtype)
    ident = torch.arange(b, dtype=torch.int32, device=cuda_device)[:, None]
    assert torch.equal(paged_cross_attention(q, kd, vd, ident, src), got)
    _, kp32, vp32, tables32, _, _ = _cross_card_inputs(
        np.random.default_rng(41), b, c, h, kv, d, src, 32, dt, cuda_device)
    assert torch.equal(paged_cross_attention(q, kp32, vp32, tables32, src),
                       got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,kv,d,src", CROSS_CASES[:4])
def test_cuda_paged_cross_mma_body_matches_plain(cuda_device, b, c, h, kv, d,
                                                 src):
    """The previous body, ``mma`` forced through ``_body`` at each served
    shape, against the plain version under the bf16 gate, over pools whose
    slots past src hold non-finite values (neither body may read them
    into P V), and the dense-cache bits equal to the paged read's."""
    q, kp, vp, tables, kd, vd = _cross_card_inputs(
        np.random.default_rng(43), b, c, h, kv, d, src, 16, torch.bfloat16,
        cuda_device)
    want = paged_cross_attention_plain(q, kp, vp, tables, src)
    nb = tables.shape[1]
    for pool in (kp, vp):                 # the last blocks' stale tails
        tail = pool[tables[:, -1].long()]
        tail[:, src - (nb - 1) * 16:] = float("nan")
        pool[tables[:, -1].long()] = tail
    for body in ("mma", "wgmma"):
        n0 = _build.bodies["paged_cross_attention"][body]
        got = paged_cross_attention(q, kp, vp, tables, src, _body=body)
        assert _build.bodies["paged_cross_attention"][body] == n0 + 1
        assert bool(torch.isfinite(got).all())
        _card_close(got, want, "bfloat16")
        ident = torch.arange(b, dtype=torch.int32,
                             device=cuda_device)[:, None]
        assert torch.equal(paged_cross_attention(q, kd, vd, ident, src,
                                                 _body=body), got)


@pytest.mark.cuda
def test_cuda_paged_cross_refuses_what_it_cannot_take(cuda_device):
    """No fallback: the mma body forced on float32, and a source longer
    than the row's blocks, raise on the card; so does the wgmma body
    forced where it does not take the shape (float32; hd 32, 112, 256;
    blocks of 4 slots, less than a swizzle atom), with no launch counted
    on another body."""
    q, kp, vp, tables, _, _ = _cross_card_inputs(
        np.random.default_rng(42), 2, 8, 4, 2, 64, 40, 16, torch.float32,
        cuda_device)
    with pytest.raises(RuntimeError):
        paged_cross_attention(q, kp, vp, tables, 40, _body="mma")
    with pytest.raises(ValueError):
        paged_cross_attention(q, kp, vp, tables, 49)
    before = dict(_build.bodies["paged_cross_attention"])
    for d, bs, dt in ((64, 16, torch.float32), (32, 16, torch.bfloat16),
                      (112, 16, torch.bfloat16), (256, 16, torch.bfloat16),
                      (64, 4, torch.bfloat16)):
        q, kp, vp, tables, _, _ = _cross_card_inputs(
            np.random.default_rng(42), 2, 8, 4, 2, d, 40, bs, dt,
            cuda_device)
        with pytest.raises(RuntimeError):
            paged_cross_attention(q, kp, vp, tables, 40, _body="wgmma")
    torch.cuda.synchronize()
    after = _build.bodies["paged_cross_attention"]
    assert {k: after[k] - before[k] for k in after} == {
        "wgmma": 5, "mma": 0, "cuda_core": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,d", [
    (8, 15, 5, 1024, 64),     # smollm-360m's slot engine
    (4, 6, 2, 24, 32),
    (2, 16, 2, 100, 128),     # G = 8, hd 128: over 48 KB of shared memory
    (8, 32, 32, 2176, 112),   # zamba2-7b's slot engine: MHA, hd 112
])
def test_cuda_dense_decode_matches_plain(cuda_device, dtype, b, h, kv, s, d):
    rng = np.random.default_rng(11)
    q, kc, vc, pos = _dense_inputs(rng, b, h, kv, s, d)
    dt = getattr(torch, dtype)
    args = [t(a).to(cuda_device, dt) for a in (q, kc, vc)] + [
        t(pos).to(cuda_device)]
    n0 = _build.launches["dense_decode_attention"]
    got = dense_decode_attention(*args)
    assert _build.launches["dense_decode_attention"] == n0 + 1
    _card_close(got, dense_decode_attention_plain(*args), dtype)
    # the same rows as one-block paged rows: the shared body gives the
    # same bits
    tables = torch.arange(b, dtype=torch.int32, device=cuda_device)[:, None]
    assert torch.equal(got, paged_decode_attention(
        args[0], args[1], args[2], tables, args[3]))


def _partial_pos(rng, b, s, s_start):
    """Logical positions over a slice [s_start, s_start + s): a row
    before it (an empty slice where s_start > 0), one on its first slot,
    one on its last, one past it (every slot valid), the rest anywhere."""
    pos = rng.integers(0, s_start + s + 8, size=b).astype(np.int32)
    pos[:4] = [max(s_start - 1, 0), s_start, s_start + s - 1,
               s_start + s + 5][:b]
    return pos


def _partials_close(got, want, tol) -> None:
    """(acc, m, l) of the kernel against the plain version's: m within
    ``tol`` of max(1, |m|), l likewise, and acc / l (the output's scale)
    within ``tol``; an empty row exactly (acc 0, l 0, m NEG_INF)."""
    (acc, m, l), (acc_p, m_p, l_p) = ([x.float().cpu() for x in y]
                                      for y in (got, want))
    empty = l_p == 0
    assert torch.equal(empty, l == 0)
    assert torch.equal(m[empty], torch.full_like(m[empty], NEG_INF))
    assert torch.equal(acc[empty.expand_as(acc)],
                       torch.zeros_like(acc[empty.expand_as(acc)]))
    assert ((m - m_p).abs() / m_p.abs().clamp(min=1)).max() <= tol
    assert ((l - l_p).abs() / l_p.abs().clamp(min=1)).max() <= tol
    assert _err(acc / l.clamp(min=1e-30), acc_p / l_p.clamp(min=1e-30)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_start", [0, 300])
@pytest.mark.parametrize("b,h,kv,s,d", [
    (8, 15, 5, 512, 64),      # smollm-360m's heads
    (4, 6, 2, 40, 32),
    (4, 64, 8, 256, 128),     # qwen2-72b's heads: G 8, hd 128
    (4, 4, 2, 48, 256),       # the wide layout
])
def test_cuda_dense_decode_partial_matches_plain(cuda_device, dtype, s_start,
                                                 b, h, kv, s, d):
    """The dense kernel's partials form over a slice starting at logical
    slot ``s_start``: each row's (acc, m, l) within 2e-5 of the plain
    version's (f32 arithmetic on both sides, in another order; m in the
    scores' units, back from the mma body's log2 domain), an empty slice
    exactly as the reference's masked max leaves it, and launched on the
    body ``decode_body`` names, counted by the form's own counter."""
    rng = np.random.default_rng(23)
    q, kc, vc, _ = _dense_inputs(rng, b, h, kv, s, d)
    dt = getattr(torch, dtype)
    args = [t(a).to(cuda_device, dt) for a in (q, kc, vc)] + [
        t(_partial_pos(rng, b, s, s_start)).to(cuda_device)]
    name = "dense_decode_attention_partial"
    body = decode_body(dt, d, h // kv)
    n0, nb0 = _build.launches[name], _build.bodies[name][body]
    got = dense_decode_attention_partial(*args, s_start)
    assert _build.launches[name] == n0 + 1
    assert _build.bodies[name][body] == nb0 + 1
    assert [x.dtype for x in got] == [torch.float32] * 3
    want = dense_decode_attention_partial_plain(*args, s_start)
    _partials_close(got, want, CARD_TOL["float32"])
    if s_start > 0:
        assert bool((got[2][0] == 0).all())      # the row before the slice


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("m,k,n", [
    (8, 960, 960), (8, 960, 320), (8, 960, 2560), (8, 2560, 960),
    (128, 960, 2560), (128, 2560, 960),      # smollm-360m's sites
    (3, 96, 48), (5, 128, 300), (1, 66, 7),  # group 32, odd N, group 2
])
def test_cuda_quant_matmul_matches_plain(cuda_device, dtype, fmt, m, k, n):
    rng = np.random.default_rng(12)
    w = t(rng.standard_normal((k, n), dtype=np.float32) * k ** -0.5)
    packed = (quantize_int8 if fmt == "int8" else quantize_int4)(w)
    q, s = packed["q"].to(cuda_device), packed["s"].to(cuda_device)
    x = t(rng.standard_normal((m, k), dtype=np.float32)).to(
        cuda_device, getattr(torch, dtype))
    kernel, plain = ((quant_matmul_int8, quant_matmul_int8_plain)
                     if fmt == "int8" else
                     (quant_matmul_int4, quant_matmul_int4_plain))
    name = f"quant_matmul_{fmt}"
    n0 = _build.launches[name]
    got = kernel(x, q, s)
    assert _build.launches[name] == n0 + 1
    assert got.shape == (m, n) and got.dtype == x.dtype
    _card_close(got, plain(x, q, s), dtype, QMM_CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [32, 64])
@pytest.mark.parametrize("m", [1, 8, 37, 128])
@pytest.mark.parametrize("k,n", SMOLLM_SITES)
def test_cuda_quant_matmul_int4_mma_body(cuda_device, k, n, m, group):
    """The int4 mma body (forced, as chip_smoke.py times it against the
    rule's wgmma body) at every smollm-360m site, decode and chunk row
    counts and two group sizes: within the bf16 gate of the plain
    version, and bit-equal over repeated calls (the split-K partials are
    summed in a fixed order)."""
    rng = np.random.default_rng(21)
    w = t(rng.standard_normal((k, n), dtype=np.float32) * k ** -0.5)
    # reprolint: disable-next=quant-static-weights -- a kernel test packs
    # one leaf at a chosen group; quantize_params picks the group from K
    packed = quantize_int4(w, group=group)
    q, s = packed["q"].to(cuda_device), packed["s"].to(cuda_device)
    assert k // s.shape[0] == group
    x = t(rng.standard_normal((m, k), dtype=np.float32)).to(
        cuda_device, torch.bfloat16)
    n0 = _build.bodies["quant_matmul_int4"]["mma"]
    got = quant_matmul_int4(x, q, s, _body="mma")
    assert _build.bodies["quant_matmul_int4"]["mma"] == n0 + 1
    _card_close(got, quant_matmul_int4_plain(x, q, s), "bfloat16",
                QMM_CARD_TOL)
    for _ in range(3):
        assert torch.equal(quant_matmul_int4(x, q, s, _body="mma"), got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 960, 2560), (128, 2560, 960)])
def test_cuda_quant_matmul_int4_cuda_core_body_in_bf16(cuda_device, m, k, n):
    """The CUDA-core body, forced on a bf16 main-path shape (as
    chip_smoke.py times it against the mma body), agrees with the plain
    version too."""
    rng = np.random.default_rng(22)
    w = t(rng.standard_normal((k, n), dtype=np.float32) * k ** -0.5)
    # reprolint: disable-next=quant-static-weights -- a kernel test packs
    # one leaf, as the other quant matmul cases here do
    packed = quantize_int4(w)
    q, s = packed["q"].to(cuda_device), packed["s"].to(cuda_device)
    x = t(rng.standard_normal((m, k), dtype=np.float32)).to(
        cuda_device, torch.bfloat16)
    n0 = _build.bodies["quant_matmul_int4"]["cuda_core"]
    got = quant_matmul_int4(x, q, s, _body="cuda_core")
    assert _build.bodies["quant_matmul_int4"]["cuda_core"] == n0 + 1
    _card_close(got, quant_matmul_int4_plain(x, q, s), "bfloat16",
                QMM_CARD_TOL)


SCAN_CARD_CASES = [
    (8, 1, 8192, 16, True, False),       # falcon-mamba-7b decode
    (1, 128, 8192, 16, True, False),     # falcon-mamba-7b prefill chunk
    (2, 100, 300, 8, False, True),       # ragged DI and T, strided B / C
    (3, 37, 256, 5, True, True),
    (8, 1, 7168, 64, True, True),        # zamba2-7b decode (B / C sliced)
    (1, 128, 7168, 64, True, True),      # zamba2-7b prefill chunk
    (2, 45, 300, 64, False, True),       # d_state 64, ragged DI and T
]
# every body, and for state_lanes every lane count the rule can pick
SCAN_BODIES = [("cuda_core", None)] + [("state_lanes", g) for g in SCAN_LANES]


def _card_scan_inputs(cuda_device, seed, b, t_, di, ds, strided):
    rng = np.random.default_rng(seed)
    dt, bm, cm, x, a_neg, h0 = [
        t(a).to(cuda_device) for a in _scan_inputs(rng, b, t_, di, ds)]
    if strided:
        proj = torch.cat([torch.zeros_like(bm[..., :3]), bm, cm], dim=-1)
        bm, cm = proj[..., 3:3 + ds], proj[..., 3 + ds:]
    return dt, bm, cm, x, a_neg, h0


@pytest.mark.cuda
@pytest.mark.parametrize("body,lanes", SCAN_BODIES)
@pytest.mark.parametrize("b,t_,di,ds,aliased,strided", SCAN_CARD_CASES)
def test_cuda_selective_scan_matches_plain(cuda_device, monkeypatch, body,
                                           lanes, b, t_, di, ds, aliased,
                                           strided):
    """float32 only, the dtype the model feeds the scan; within 2e-5 of
    max(1, |plain|) (the kernel sums y over d_state in its own order).
    Each launch counts once, under its body."""
    dt, bm, cm, x, a_neg, h0 = _card_scan_inputs(cuda_device, 18, b, t_, di,
                                                 ds, strided)
    if lanes is not None:
        monkeypatch.setattr(scan_mod, "scan_lanes", lambda *a: lanes)
    want_y, want_h = selective_scan_plain(dt, bm, cm, x, a_neg, h0)
    h = h0.clone()
    n0 = _build.launches["selective_scan"]
    by0 = dict(_build.bodies["selective_scan"])
    y, h_t = selective_scan(dt, bm, cm, x, a_neg, h,
                            h_out=h if aliased else None,
                            _body=None if body == "state_lanes" else body)
    assert _build.launches["selective_scan"] == n0 + 1
    assert _build.bodies["selective_scan"] == {
        k: v + (k == body) for k, v in by0.items()}
    assert (h_t is h) == aliased
    if not aliased:
        assert torch.equal(h, h0)
    assert _rel_err(y.cpu(), want_y.cpu()) <= CARD_TOL["float32"]
    assert _rel_err(h_t.cpu(), want_h.cpu()) <= CARD_TOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", SCAN_LANES)
@pytest.mark.parametrize("b,t_,di,ds,aliased,strided", SCAN_CARD_CASES)
def test_cuda_selective_scan_state_lanes_h_equals_previous_body(
        cuda_device, monkeypatch, lanes, b, t_, di, ds, aliased, strided):
    """state_lanes applies the previous body's operations to each state
    element in its order, so h_T is bit-equal to cuda_core's on the same
    inputs, at every lane count; repeated calls give the same bits."""
    args = _card_scan_inputs(cuda_device, 19, b, t_, di, ds, strided)
    monkeypatch.setattr(scan_mod, "scan_lanes", lambda *a: lanes)
    _, h_core = selective_scan(*args, _body="cuda_core")
    y, h = selective_scan(*args)
    assert torch.equal(h, h_core)
    for _ in range(3):
        y2, h2 = selective_scan(*args)
        assert torch.equal(y2, y) and torch.equal(h2, h)


# the scan's backward kernel: smoke widths (d_state 16, 64 and a ragged 5;
# T below, at and past a checkpoint's 32 steps, and off a sub-chunk's 4;
# DI off a block's 256 / G channels; B / C column slices) and
# full widths (falcon-mamba-7b's DI 8192, d_state 16; zamba2-7b's DI 7168,
# d_state 64, A as Mamba2 expands it) over 256 steps
SCAN_BWD_CARD_CASES = [(2, 48, 256, 16, True, False),
                       (1, 32, 300, 64, True, False),
                       (2, 20, 130, 5, False, False),
                       (1, 75, 200, 5, True, True),
                       (1, 70, 96, 8, False, True),
                       (2, 256, 8192, 16, False, False),
                       (2, 256, 7168, 64, True, True)]


def _card_scan_grad_inputs(cuda_device, seed, b, t_, di, ds, strided,
                           mamba2):
    """Inputs in the model's range (dt a softplus around the init's
    dt_bias of -2; A around Mamba1's -(1..d_state), or with ``mamba2``
    one value a channel around Mamba2's init of -1, as ``_mamba2_scan``
    expands it over d_state) and a cotangent of y and of h_T, on the
    card.  (With Mamba1's A at d_state 64, d(dt) sums 64 terms of up to
    |g h A| with A near -64 into a result that cancels, and two float32
    sums of them differ by up to 5e-5 of it.)"""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    dt = np.log1p(np.exp(f32(b, t_, di) - 2))
    if mamba2:
        a_neg = np.repeat(-np.exp(0.3 * f32(di, 1)), ds, axis=1)
    else:
        a_neg = -np.exp(np.log(np.arange(1, ds + 1, dtype=np.float32))
                        + 0.3 * f32(di, ds))
    dt, bm, cm, x, a_neg, dy, dh = (
        t(a.astype(np.float32)).to(cuda_device)
        for a in (dt, f32(b, t_, ds), f32(b, t_, ds), f32(b, t_, di), a_neg,
                  f32(b, t_, di), f32(b, di, ds)))
    if strided:
        proj = torch.cat([torch.zeros_like(bm[..., :3]), bm, cm], dim=-1)
        bm, cm = proj[..., 3:3 + ds], proj[..., 3 + ds:]
    return dt, bm, cm, x, a_neg, dy, dh


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_,di,ds,strided,mamba2", SCAN_BWD_CARD_CASES)
def test_cuda_selective_scan_backward_matches_plain(cuda_device, b, t_, di,
                                                    ds, strided, mamba2):
    """The forward with checkpoints gives the bits of the forward without
    (y and h_T) and the plain version's checkpoints within 2e-5 of max(1,
    |plain|); the backward kernel, from those checkpoints, gives every
    gradient within 2e-5 of max(1, |plain|) of
    ``selective_scan_backward_plain`` on the card, one launch each, and
    the same bits on a second launch (no float atomics)."""
    from repro_torch.kernels.selective_scan import (
        scan_checkpoints, selective_scan_backward,
        selective_scan_backward_plain)
    dt, bm, cm, x, a_neg, dy, dh = _card_scan_grad_inputs(
        cuda_device, 21, b, t_, di, ds, strided, mamba2)
    h0 = torch.zeros((b, di, ds), device=cuda_device)
    ckpt = torch.empty((b, scan_checkpoints(t_), di, ds), device=cuda_device)
    y0, h_0 = selective_scan(dt, bm, cm, x, a_neg, h0)
    y1, h_1 = selective_scan(dt, bm, cm, x, a_neg, h0, checkpoints=ckpt)
    assert torch.equal(y0, y1) and torch.equal(h_0, h_1)
    want_ck = torch.empty_like(ckpt)
    selective_scan_plain(dt, bm, cm, x, a_neg, h0, checkpoints=want_ck)
    assert _rel_err(ckpt.cpu(), want_ck.cpu()) <= CARD_TOL["float32"]
    want = selective_scan_backward_plain(dt, bm, cm, x, a_neg, want_ck, dy,
                                         dh)
    n0 = _build.launches["selective_scan_backward"]
    got = selective_scan_backward(dt, bm, cm, x, a_neg, ckpt, dy, dh)
    again = selective_scan_backward(dt, bm, cm, x, a_neg, ckpt, dy, dh)
    torch.cuda.synchronize()
    assert _build.launches["selective_scan_backward"] == n0 + 2
    for name, g, w, g2 in zip(("dt", "B", "C", "x", "A", "h0"), got, want,
                              again):
        assert g.shape == w.shape, name
        assert _rel_err(g.cpu(), w.cpu()) <= CARD_TOL["float32"], name
        assert torch.equal(g, g2), name


# gemma3-12b's shapes (C 128, H 16, KV 8, hd 256, w 1024) at pos 0, 512
# (ring partly filled) and 3000 (wrapped), mixtral-8x7b's (H 32, KV 8,
# hd 128, w 4096) wrapped, chunks longer than the ring (at hd 32, and at
# hd 256 on 2 splits), and small ragged shapes (hd off the 4-wide groups
# and the k16 steps, G = 3)
RING_CASES = [(0, 128, 16, 8, 256, 1024), (512, 128, 16, 8, 256, 1024),
              (3000, 128, 16, 8, 256, 1024), (5000, 128, 32, 8, 128, 4096),
              (45, 64, 6, 2, 32, 32), (7, 5, 6, 2, 30, 32),
              (100, 33, 4, 4, 64, 48), (300, 160, 16, 8, 256, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,c,h,kv,d,w", RING_CASES)
def test_cuda_ring_chunk_matches_plain(cuda_device, dtype, pos, c, h, kv, d,
                                       w):
    """The ring kernel against its plain version on the card, one launch
    counted on the body ``ring_body`` names (``mma`` in bf16 on the
    tensor-core tiles, ``cuda_core`` elsewhere); the same keys in blocks
    of 32, and as a dense one-block ring of w slots, give the same bits
    as blocks of 16."""
    dt = getattr(torch, dtype)
    args, ring = _ring_card_args(cuda_device, dt, pos, c, h, kv, d, w)
    body = ring_body(dt, d)
    n0 = _build.bodies["ring_chunk_attention"][body]
    got = ring_chunk_attention(*args)
    assert _build.bodies["ring_chunk_attention"][body] == n0 + 1
    assert torch.isfinite(got.float()).all()
    _card_close(got, ring_chunk_attention_plain(*args), dtype)
    nb32 = -(-w // 32)
    pools32 = []
    for r in ring:
        pool = torch.zeros((nb32 + 1, 32, kv, d))
        pool[1:].reshape(-1, kv, d)[:w] = r
        pools32.append(pool.to(cuda_device, dt))
    table32 = torch.arange(1, nb32 + 1, dtype=torch.int32, device=cuda_device)
    assert torch.equal(got, ring_chunk_attention(
        args[0], *pools32, table32, *args[4:]))
    dense = [r[None].to(cuda_device, dt) for r in ring]
    assert torch.equal(got, ring_chunk_attention(
        args[0], *dense, torch.zeros(1, dtype=torch.int32,
                                     device=cuda_device), *args[4:]))


def _ring_card_args(cuda_device, dt, pos, c, h, kv, d, w):
    """A ring case's wrapper arguments on the card (blocks of 16) and the
    ring's w slots of K and V in logical order, on the CPU."""
    rng = np.random.default_rng(31 + pos)
    q, k, v, kp, vp, table = _ring_inputs(rng, pos, c, w, h, kv, d, 16)

    def card(a):
        return t(np.ascontiguousarray(a)).to(cuda_device, dt)
    args = (card(q[pos:]), card(kp), card(vp), t(table).to(cuda_device),
            card(k[pos:]), card(v[pos:]), pos, w)
    ring = [t(a.reshape(-1, kv, d)[np.concatenate(
        [np.arange(b * 16, b * 16 + 16) for b in table])][:w])
        for a in (kp, vp)]
    return args, ring


@pytest.mark.cuda
@pytest.mark.parametrize("pos,c,h,kv,d,w", [
    case for case in RING_CASES
    if prefill_body(torch.bfloat16, case[4]) == "mma"])
def test_cuda_ring_mma_within_the_gate_of_cuda_core(cuda_device, pos, c, h,
                                                    kv, d, w):
    """In bf16 the tensor-core ``mma`` body (forced where the rule names
    ``wgmma``, as chip_smoke.py times it in turns) and the previous
    CUDA-core body, on the same inputs, agree within the card's bf16 gate
    (both compute in f32 and round once)."""
    args, _ = _ring_card_args(cuda_device, torch.bfloat16, pos, c, h, kv, d,
                              w)
    n0 = dict(_build.bodies["ring_chunk_attention"])
    got = ring_chunk_attention(*args, _body="mma")
    prev = ring_chunk_attention(*args, _body="cuda_core")
    assert _build.bodies["ring_chunk_attention"] == {
        "wgmma": n0["wgmma"], "mma": n0["mma"] + 1,
        "cuda_core": n0["cuda_core"] + 1}
    _card_close(got, prev, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["mma", "cuda_core"])
@pytest.mark.parametrize("pos,c,h,kv,d,w", [
    RING_CASES[0], RING_CASES[2], RING_CASES[3], RING_CASES[4],
    RING_CASES[-1]])
def test_cuda_ring_device_pos_equals_host_pos(cuda_device, body, pos, c, h,
                                              kv, d, w):
    """pos as a (1,) int32 tensor on the card, read there by the CTAs,
    gives the bits of the host-int call at the same pos, on both bodies
    (bf16)."""
    args, _ = _ring_card_args(cuda_device, torch.bfloat16, pos, c, h, kv, d,
                              w)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda_device)
    n0 = _build.bodies["ring_chunk_attention"][body]
    got = ring_chunk_attention(*args[:6], pos_t, w, _body=body)
    assert _build.bodies["ring_chunk_attention"][body] == n0 + 1
    assert torch.equal(got, ring_chunk_attention(*args, _body=body))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["paged", "dense"])
def test_cuda_ring_decode_at_mixtral_heads(cuda_device, dtype, kernel):
    """A decode over mixtral-8x7b's ring (H 32, KV 8, hd 128, w 4096 in
    blocks of 16) as the attention layer makes it: the decode kernels at
    pos clamped at w - 1, for rows before the wrap, at w - 1 and past it.
    In bf16 the launch takes the mma body (hd 128, G 4)."""
    rng = np.random.default_rng(47)
    b, h, kv, d, w, bs = 4, 32, 8, 128, 4096, 16
    pos = np.minimum(np.array([100, w - 1, w, 9000], np.int32), w - 1)
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    dt = getattr(torch, dtype)
    if kernel == "paged":
        nb = w // bs
        kp = rng.standard_normal((b * nb + 1, bs, kv, d), dtype=np.float32)
        vp = rng.standard_normal((b * nb + 1, bs, kv, d), dtype=np.float32)
        tables = (rng.permutation(b * nb).reshape(b, nb) + 1).astype(np.int32)
        args = [t(a).to(cuda_device, dt) for a in (q, kp, vp)] + [
            t(a).to(cuda_device) for a in (tables, pos)]
        fn, plain = paged_decode_attention, paged_decode_attention_plain
    else:
        kc = rng.standard_normal((b, w, kv, d), dtype=np.float32)
        vc = rng.standard_normal((b, w, kv, d), dtype=np.float32)
        args = [t(a).to(cuda_device, dt) for a in (q, kc, vc)] + [
            t(pos).to(cuda_device)]
        fn, plain = dense_decode_attention, dense_decode_attention_plain
    name = f"{kernel}_decode_attention"
    body = "mma" if dtype == "bfloat16" else "cuda_core"
    n0 = _build.bodies[name][body]
    got = fn(*args)
    assert _build.bodies[name][body] == n0 + 1
    _card_close(got, plain(*args), dtype)


# ----------------------------------------------------------------------
# on the card: the int8 tensor-core body
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 37, 128])
@pytest.mark.parametrize("k,n", SMOLLM_SITES + [(96, 48), (48, 16)])
def test_cuda_quant_matmul_int8_mma_body(cuda_device, k, n, m):
    """The int8 mma body (forced) at every smollm-360m site (wq / wo,
    wk / wv, w_gate / w_up, w_down), decode and chunk row counts, and
    two K that end inside a stage (96, and 48 with a single warp's N):
    within the bf16 gate of the plain version, and bit-equal over
    repeated calls (the split-K partials are summed in a fixed order)."""
    rng = np.random.default_rng(23)
    w = t(rng.standard_normal((k, n), dtype=np.float32) * k ** -0.5)
    # reprolint: disable-next=quant-static-weights -- a kernel test packs
    # one leaf, as the int4 kernel tests here do
    packed = quantize_int8(w)
    q, s = packed["q"].to(cuda_device), packed["s"].to(cuda_device)
    x = t(rng.standard_normal((m, k), dtype=np.float32)).to(
        cuda_device, torch.bfloat16)
    n0 = _build.bodies["quant_matmul_int8"]["mma"]
    got = quant_matmul_int8(x, q, s, _body="mma")
    assert _build.bodies["quant_matmul_int8"]["mma"] == n0 + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _card_close(got, quant_matmul_int8_plain(x, q, s), "bfloat16",
                QMM_CARD_TOL)
    for _ in range(3):
        assert torch.equal(quant_matmul_int8(x, q, s, _body="mma"), got)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("k,n", TARGET_SITES)
def test_cuda_quant_matmul_at_the_speculation_targets_widths(cuda_device,
                                                             fmt, k, n):
    """qwen2-72b's and command-r-35b's MLP at decode (8 rows; w_gate /
    w_up and w_down): the mma body (forced), its K split
    (``quant_splits``) and the bf16 gate of the plain version, and the
    same bits over repeated calls."""
    rng = np.random.default_rng(29)
    w = t(rng.standard_normal((k, n), dtype=np.float32) * k ** -0.5)
    packed = (quantize_int8 if fmt == "int8" else quantize_int4)(w)
    del w
    q, s = packed["q"].to(cuda_device), packed["s"].to(cuda_device)
    x = t(rng.standard_normal((8, k), dtype=np.float32)).to(
        cuda_device, torch.bfloat16)
    kernel, plain = ((quant_matmul_int8, quant_matmul_int8_plain)
                     if fmt == "int8" else
                     (quant_matmul_int4, quant_matmul_int4_plain))
    name = f"quant_matmul_{fmt}"
    n0 = _build.bodies[name]["mma"]
    got = kernel(x, q, s, _body="mma")
    assert _build.bodies[name]["mma"] == n0 + 1
    assert 1 <= quant_splits(8, k, n) <= 8
    assert got.shape == (8, n) and got.dtype == torch.bfloat16
    _card_close(got, plain(x, q, s), "bfloat16", QMM_CARD_TOL)
    assert torch.equal(kernel(x, q, s, _body="mma"), got)


def _wgmma_case(device, fmt, m, k, n, group, seed):
    """Packed weights (int4 at ``group``), bf16 x and the kernels of a
    wgmma card test, on the card."""
    rng = np.random.default_rng(seed)
    w = t(rng.standard_normal((k, n), dtype=np.float32) * k ** -0.5)
    if fmt == "int8":
        # reprolint: disable-next=quant-static-weights -- a kernel test
        # packs one leaf, as the mma body's tests do
        packed = quantize_int8(w)
    else:
        # reprolint: disable-next=quant-static-weights -- a kernel test
        # packs one leaf at a chosen group, as the mma body's tests do
        packed = quantize_int4(w, group=group)
    del w
    q, s = packed["q"].to(device), packed["s"].to(device)
    x = t(rng.standard_normal((m, k), dtype=np.float32)).to(
        device, torch.bfloat16)
    kernel, plain = ((quant_matmul_int8, quant_matmul_int8_plain)
                     if fmt == "int8" else
                     (quant_matmul_int4, quant_matmul_int4_plain))
    return x, q, s, kernel, plain


def _check_wgmma(fmt, x, q, s, kernel, plain):
    """The wgmma body (forced: int8 below ``WGMMA_INT8_MIN_BYTES`` is the
    mma body's by the rule): one launch counted on it, within the bf16
    gate of the plain version and of the mma body on the same inputs,
    and the same bits over repeated calls."""
    name = f"quant_matmul_{fmt}"
    m, n = x.shape[0], q.shape[1]
    n0 = _build.bodies[name]["wgmma"]
    got = kernel(x, q, s, _body="wgmma")
    assert _build.bodies[name]["wgmma"] == n0 + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _card_close(got, plain(x, q, s), "bfloat16", QMM_CARD_TOL)
    _card_close(got, kernel(x, q, s, _body="mma"), "bfloat16", QMM_CARD_TOL)
    for _ in range(3):
        assert torch.equal(kernel(x, q, s, _body="wgmma"), got)


# ----------------------------------------------------------------------
# on the card: the int8 / int4 wgmma body
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("fmt,group", [("int8", None), ("int4", 32),
                                       ("int4", 64)])
@pytest.mark.parametrize("m", [1, 8, 37, 128])
@pytest.mark.parametrize("k,n", SMOLLM_SITES)
def test_cuda_quant_matmul_wgmma_body(cuda_device, fmt, group, m, k, n):
    """The wgmma body at every smollm-360m site (wq / wo, wk / wv,
    w_gate / w_up, w_down), decode and chunk row counts and, for int4,
    groups of 32 (folded as each ends) and 64 (two accumulators in
    turns): within the bf16 gate of the plain version and of the mma
    body, bit-equal over repeated calls."""
    x, q, s, kernel, plain = _wgmma_case(cuda_device, fmt, m, k, n, group,
                                         31)
    _check_wgmma(fmt, x, q, s, kernel, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 8, 70])
@pytest.mark.parametrize("fmt,group,k,n", [
    ("int8", None, 96, 48), ("int8", None, 48, 16), ("int8", None, 160, 208),
    ("int8", None, 1008, 400), ("int4", 16, 96, 48), ("int4", 48, 48, 16),
    ("int4", 32, 160, 208), ("int4", 48, 1008, 400), ("int4", 128, 1024,
                                                       400)])
def test_cuda_quant_matmul_wgmma_ragged(cuda_device, fmt, group, m, k, n):
    """K ending inside a stage (48, 96, 160, 1008: TMA zero-fills past
    it), N not a multiple of the 128-column tile (16, 48, 208, 400),
    groups that end inside a stage (16, 32, 48) and a group of two whole
    stages (128): within the gates, bit-equal."""
    x, q, s, kernel, plain = _wgmma_case(cuda_device, fmt, m, k, n, group,
                                         32)
    _check_wgmma(fmt, x, q, s, kernel, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("k,n", TARGET_SITES[:2])
def test_cuda_quant_matmul_wgmma_at_qwen2_mlp(cuda_device, fmt, m, k, n):
    """qwen2-72b's MLP (w_gate / w_up 8192 -> 29568, w_down 29568 ->
    8192) at decode (M 8) and at a prefill chunk (M 128), int4 at its
    packer's group of 64: the wgmma body within the gates, bit-equal."""
    x, q, s, kernel, plain = _wgmma_case(cuda_device, fmt, m, k, n,
                                         int4_group(k), 33)
    assert (int8_body(x.dtype, k, n) if fmt == "int8"
            else int4_body(x.dtype, m, k, n, int4_group(k))) == "wgmma"
    _check_wgmma(fmt, x, q, s, kernel, plain)


@pytest.mark.cuda
def test_cuda_quant_wgmma_refuses_without_a_launch(cuda_device):
    """A forced wgmma launch on a shape or dtype the body does not take
    raises before any launch: no fallback to another body."""
    _build.reset_launches()
    q = torch.zeros((64, 40), dtype=torch.int8, device=cuda_device)
    s = torch.ones((1, 40), device=cuda_device)
    for x in (torch.zeros((8, 64), device=cuda_device),
              torch.zeros((8, 64), dtype=torch.bfloat16,
                          device=cuda_device)):
        with pytest.raises(ValueError):
            quant_matmul_int8(x, q, s, _body="wgmma")
    assert _build.launches["quant_matmul_int8"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 960, 2560), (128, 2560, 960)])
def test_cuda_quant_matmul_int8_cuda_core_body_in_bf16(cuda_device, m, k, n):
    """The CUDA-core body, forced on a bf16 main-path shape (as
    chip_smoke.py times it against the mma body), agrees with the plain
    version too."""
    rng = np.random.default_rng(24)
    w = t(rng.standard_normal((k, n), dtype=np.float32) * k ** -0.5)
    # reprolint: disable-next=quant-static-weights -- a kernel test packs
    # one leaf, as the int4 kernel tests here do
    packed = quantize_int8(w)
    q, s = packed["q"].to(cuda_device), packed["s"].to(cuda_device)
    x = t(rng.standard_normal((m, k), dtype=np.float32)).to(
        cuda_device, torch.bfloat16)
    n0 = _build.bodies["quant_matmul_int8"]["cuda_core"]
    got = quant_matmul_int8(x, q, s, _body="cuda_core")
    assert _build.bodies["quant_matmul_int8"]["cuda_core"] == n0 + 1
    _card_close(got, quant_matmul_int8_plain(x, q, s), "bfloat16",
                QMM_CARD_TOL)


# ----------------------------------------------------------------------
# on the card: the split-slot decode body
# ----------------------------------------------------------------------
SPLIT_NB, SPLIT_BS = 64, 16          # smollm-360m's pool: 1024 slots a row


def _split_inputs(rng, pos_list, h=15, kv=5, d=64):
    """Paged decode inputs at smollm-360m's heads for rows at the given
    positions; the last row is masked (frozen pos, all-zero table)."""
    b = len(pos_list) + 1
    q, kp, vp, tables, _ = _paged_inputs(rng, b, h, kv, SPLIT_NB, SPLIT_BS, d)
    pos = np.array(list(pos_list) + [5], np.int32)
    tables[-1] = 0
    return q, kp, vp, tables, pos


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 63, 64, 127, 616, SPLIT_NB * SPLIT_BS - 1])
def test_cuda_split_decode_matches_plain(cuda_device, pos):
    """The split body at a row's first slot, tile edges, the main path's
    longest row and a full row, beside rows at other positions and a
    masked row on the scratch block: within the bf16 gate of the plain
    version, paged and dense, and bit-equal over repeated calls."""
    rng = np.random.default_rng(25 + pos)
    q, kp, vp, tables, pos_np = _split_inputs(
        rng, [pos, 1, 300, 1000, 17, 511, pos])
    args = [t(a).to(cuda_device, torch.bfloat16) for a in (q, kp, vp)] + [
        t(a).to(cuda_device) for a in (tables, pos_np)]
    n0 = _build.bodies["paged_decode_attention"]["mma"]
    got = paged_decode_attention(*args)
    assert _build.bodies["paged_decode_attention"]["mma"] == n0 + 1
    _card_close(got, paged_decode_attention_plain(*args), "bfloat16")
    for _ in range(3):
        assert torch.equal(paged_decode_attention(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 64, 616, SPLIT_NB * SPLIT_BS - 1])
def test_cuda_split_decode_bits_do_not_depend_on_blocks(cuda_device, dtype,
                                                        pos):
    """The same logical K/V as a shuffled table of 16-slot blocks, as
    one paged block of all the slots, and as the slot engine's dense
    rows gives the same bits (the bf16 split body and the f32 body
    alike)."""
    rng = np.random.default_rng(26)
    b, h, kv, d = 4, 15, 5, 64
    cap = SPLIT_NB * SPLIT_BS
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    k = rng.standard_normal((b, cap, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, cap, kv, d), dtype=np.float32)
    tables = (rng.permutation(b * SPLIT_NB).reshape(b, SPLIT_NB) + 1
              ).astype(np.int32)
    kp = np.zeros((b * SPLIT_NB + 1, SPLIT_BS, kv, d), np.float32)
    vp = np.zeros_like(kp)
    kp[tables] = k.reshape(b, SPLIT_NB, SPLIT_BS, kv, d)
    vp[tables] = v.reshape(b, SPLIT_NB, SPLIT_BS, kv, d)
    pos_np = np.array([pos, 3, 700, cap - 1], np.int32)
    dt = getattr(torch, dtype)

    def card(a):
        return t(a).to(cuda_device, dt)
    pos_t = t(pos_np).to(cuda_device)
    paged = paged_decode_attention(card(q), card(kp), card(vp),
                                   t(tables).to(cuda_device), pos_t)
    one_block = paged_decode_attention(
        card(q), card(k), card(v),
        torch.arange(b, dtype=torch.int32, device=cuda_device)[:, None],
        pos_t)
    dense = dense_decode_attention(card(q), card(k), card(v), pos_t)
    assert torch.equal(paged, one_block)
    assert torch.equal(paged, dense)
    _card_close(paged, paged_decode_attention_plain(
        card(q), card(kp), card(vp), t(tables).to(cuda_device), pos_t),
        dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d", [
    (8, 15, 5, 1024, 64),     # smollm-360m's slot engine
    (3, 6, 2, 40, 32),        # S not a multiple of 16
    (2, 16, 2, 100, 128),     # G = 8, hd 128
    (1, 16, 1, 64, 16),       # G = 16 fills the m16 side
])
def test_cuda_split_dense_decode_matches_plain(cuda_device, b, h, kv, s, d):
    """The dense kernel's split body against its plain version, with a
    row at pos 0, one at S - 1 and one frozen past the cache; bit-equal
    to the paged kernel on one-block rows and over repeated calls."""
    rng = np.random.default_rng(27)
    q, kc, vc, pos = _dense_inputs(rng, max(b, 3), h, kv, s, d)
    q, kc, vc, pos = q[:b], kc[:b], vc[:b], pos[-b:]
    args = [t(a).to(cuda_device, torch.bfloat16) for a in (q, kc, vc)] + [
        t(np.ascontiguousarray(pos)).to(cuda_device)]
    n0 = _build.bodies["dense_decode_attention"]["mma"]
    got = dense_decode_attention(*args)
    assert _build.bodies["dense_decode_attention"]["mma"] == n0 + 1
    _card_close(got, dense_decode_attention_plain(*args), "bfloat16")
    tables = torch.arange(b, dtype=torch.int32, device=cuda_device)[:, None]
    assert torch.equal(got, paged_decode_attention(
        args[0], args[1], args[2], tables, args[3]))
    for _ in range(3):
        assert torch.equal(dense_decode_attention(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["paged", "dense"])
def test_cuda_decode_cuda_core_body_in_bf16(cuda_device, kernel):
    """The one-CTA CUDA-core body, forced on the bf16 main-path shape (as
    chip_smoke.py times it against the split body), agrees with the
    plain version too."""
    rng = np.random.default_rng(28)
    q, kp, vp, tables, pos = _split_inputs(rng, [616, 64, 300, 5, 1, 450, 90])
    bf = torch.bfloat16
    if kernel == "paged":
        args = [t(a).to(cuda_device, bf) for a in (q, kp, vp)] + [
            t(a).to(cuda_device) for a in (tables, pos)]
        fn, plain = paged_decode_attention, paged_decode_attention_plain
    else:
        kc = rng.standard_normal((len(pos), 1024, 5, 64), dtype=np.float32)
        vc = rng.standard_normal((len(pos), 1024, 5, 64), dtype=np.float32)
        args = [t(a).to(cuda_device, bf) for a in (q, kc, vc)] + [
            t(pos).to(cuda_device)]
        fn, plain = dense_decode_attention, dense_decode_attention_plain
    name = f"{kernel}_decode_attention"
    n0 = _build.bodies[name]["cuda_core"]
    got = fn(*args, _body="cuda_core")
    assert _build.bodies[name]["cuda_core"] == n0 + 1
    _card_close(got, plain(*args), "bfloat16")


# ----------------------------------------------------------------------
# on the card: the wide (hd 256) tensor-core bodies, at gemma3-12b's
# heads (H 16, KV 8, G 2) over rows of 2176 slots in blocks of 16
# ----------------------------------------------------------------------
WIDE_H, WIDE_KV, WIDE_D, WIDE_NB, WIDE_BS = 16, 8, 256, 136, 16


def _wide_prefill_inputs(rng, c):
    q = rng.standard_normal((c, WIDE_H, WIDE_D), dtype=np.float32)
    k = rng.standard_normal((WIDE_NB * WIDE_BS, WIDE_KV, WIDE_D),
                            dtype=np.float32)
    v = rng.standard_normal((WIDE_NB * WIDE_BS, WIDE_KV, WIDE_D),
                            dtype=np.float32)
    return q, k, v


def _paged_from_rows(a, bs, table):
    """Logical slot rows ``a`` (S, KV, D) as a pool of blocks of ``bs``
    (block 0 scratch) through ``table``."""
    nb = a.shape[0] // bs
    pool = np.zeros((nb + 1, bs) + a.shape[1:], np.float32)
    pool[table] = a.reshape((nb, bs) + a.shape[1:])
    return pool


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 1024, 2048])
@pytest.mark.parametrize("c", [1, 77, 128])
def test_cuda_wide_prefill_matches_plain(cuda_device, dtype, c, pos):
    """The paged prefill at hd 256: bf16 takes the wide mma body (its key
    range split across a cluster), float32 the cuda_core body; within
    the card's gate of the plain version, one launch counted on the
    rule's body, and repeated calls bit-equal."""
    rng = np.random.default_rng(40 + c + pos)
    q, k, v = _wide_prefill_inputs(rng, c)
    table = (rng.permutation(WIDE_NB) + 1).astype(np.int32)
    dt = getattr(torch, dtype)
    args = [t(a).to(cuda_device, dt) for a in (
        q, _paged_from_rows(k, WIDE_BS, table),
        _paged_from_rows(v, WIDE_BS, table))] + [t(table).to(cuda_device)]
    body = "mma" if dtype == "bfloat16" else "cuda_core"
    assert prefill_body(dt, WIDE_D) == body
    n0 = _build.bodies["paged_prefill_attention"][body]
    got = paged_prefill_attention(*args, pos)
    assert _build.bodies["paged_prefill_attention"][body] == n0 + 1
    _card_close(got, paged_prefill_attention_plain(*args, pos), dtype)
    assert torch.equal(paged_prefill_attention(*args, pos), got)


@pytest.mark.cuda
@pytest.mark.parametrize("c,pos", [(128, 1024), (128, 2048), (77, 300),
                                   (1, 2175)])
def test_cuda_wide_prefill_bits_do_not_depend_on_blocks(cuda_device, c, pos):
    """The wide body cuts its tiles and splits by logical slot: the same
    K/V in shuffled blocks of 16, of 32 and as one dense block gives the
    same bits."""
    rng = np.random.default_rng(50 + pos)
    q, k, v = _wide_prefill_inputs(rng, c)
    outs = []
    for bs in (16, 32):
        table = (rng.permutation(WIDE_NB * WIDE_BS // bs) + 1).astype(np.int32)
        outs.append(paged_prefill_attention(
            *[t(a).to(cuda_device, torch.bfloat16) for a in (
                q, _paged_from_rows(k, bs, table),
                _paged_from_rows(v, bs, table))],
            t(table).to(cuda_device), pos))
    outs.append(paged_prefill_attention(
        *[t(a).to(cuda_device, torch.bfloat16) for a in (q, k[None], v[None])],
        torch.zeros(1, dtype=torch.int32, device=cuda_device), pos))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("c,pos", [(5, [0, 1000, 2100, 17]),
                                   (9, [300, 2167, 64])])
def test_cuda_wide_chunk_matches_plain_and_one_row_calls(cuda_device, c, pos):
    """The batched form at hd 256 on the wide body: within the gate of its
    plain version, and each row bit-equal to a one-row call at its pos
    (the split depends on shapes, not on the batch)."""
    rng = np.random.default_rng(60 + c)
    b = len(pos)
    q, kp, vp, tables, pos = _chunk_card_inputs(
        rng, b, c, WIDE_H, WIDE_KV, WIDE_D, WIDE_BS, WIDE_NB, pos)
    args = [t(a).to(cuda_device, torch.bfloat16) for a in (q, kp, vp)] + [
        t(a).to(cuda_device) for a in (tables, pos)]
    n0 = _build.bodies["paged_chunk_attention"]["mma"]
    got = paged_chunk_attention(*args)
    assert _build.bodies["paged_chunk_attention"]["mma"] == n0 + 1
    _card_close(got, paged_chunk_attention_plain(*args), "bfloat16")
    for row in range(b):
        assert torch.equal(got[row], paged_prefill_attention(
            args[0][row].contiguous(), args[1], args[2],
            args[3][row].contiguous(), int(pos[row])))


#: decode rows of gemma3-12b: positions at and beside the 16-slot chunk
#: edges the split cuts at, the last slot of a linear row, and (ring) the
#: pos the model clamps to w - 1
WIDE_DECODE_POS = {"linear": [0, 15, 16, 79, 80, 1023, 1500, 2175],
                   "ring": [5, 300, 1022, 1023, 1023, 1023, 16, 1023]}


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["linear", "ring"])
def test_cuda_wide_split_decode_paged_equals_dense(cuda_device, rows):
    """The split decode's wide layout (slots on m16, G = 2 heads on n8)
    at gemma3-12b's shapes: within the bf16 gate of the plain version;
    paged (shuffled blocks of 16) and dense give the same bits; repeated
    calls too."""
    rng = np.random.default_rng(70)
    cap = 1024 if rows == "ring" else WIDE_NB * WIDE_BS
    pos = np.array(WIDE_DECODE_POS[rows], np.int32)
    b = len(pos)
    q = rng.standard_normal((b, WIDE_H, WIDE_D), dtype=np.float32)
    k = rng.standard_normal((b, cap, WIDE_KV, WIDE_D), dtype=np.float32)
    v = rng.standard_normal((b, cap, WIDE_KV, WIDE_D), dtype=np.float32)
    nb = cap // WIDE_BS
    tables = (rng.permutation(b * nb).reshape(b, nb) + 1).astype(np.int32)
    kp = np.zeros((b * nb + 1, WIDE_BS, WIDE_KV, WIDE_D), np.float32)
    vp = np.zeros_like(kp)
    kp[tables] = k.reshape(b, nb, WIDE_BS, WIDE_KV, WIDE_D)
    vp[tables] = v.reshape(b, nb, WIDE_BS, WIDE_KV, WIDE_D)

    def card(a):
        return t(a).to(cuda_device, torch.bfloat16)
    pos_t = t(pos).to(cuda_device)
    paged_args = (card(q), card(kp), card(vp), t(tables).to(cuda_device),
                  pos_t)
    n0 = _build.bodies["paged_decode_attention"]["mma"]
    paged = paged_decode_attention(*paged_args)
    assert _build.bodies["paged_decode_attention"]["mma"] == n0 + 1
    _card_close(paged, paged_decode_attention_plain(*paged_args), "bfloat16")
    n0 = _build.bodies["dense_decode_attention"]["mma"]
    dense = dense_decode_attention(card(q), card(k), card(v), pos_t)
    assert _build.bodies["dense_decode_attention"]["mma"] == n0 + 1
    assert torch.equal(paged, dense)
    for _ in range(3):
        assert torch.equal(paged_decode_attention(*paged_args), paged)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["prefill", "paged", "dense"])
def test_cuda_wide_cuda_core_bodies_in_bf16(cuda_device, kernel):
    """The previous CUDA-core bodies, forced at hd 256 in bf16 (as
    chip_smoke.py times them against the wide bodies), still agree with
    the plain versions."""
    rng = np.random.default_rng(80)
    bf = torch.bfloat16
    if kernel == "prefill":
        q, k, v = _wide_prefill_inputs(rng, 128)
        table = (rng.permutation(WIDE_NB) + 1).astype(np.int32)
        args = [t(a).to(cuda_device, bf) for a in (
            q, _paged_from_rows(k, WIDE_BS, table),
            _paged_from_rows(v, WIDE_BS, table))] + [
            t(table).to(cuda_device), 1024]
        fn, plain, name = (paged_prefill_attention,
                           paged_prefill_attention_plain,
                           "paged_prefill_attention")
    else:
        pos = np.array(WIDE_DECODE_POS["linear"], np.int32)
        b, cap = len(pos), WIDE_NB * WIDE_BS
        q = rng.standard_normal((b, WIDE_H, WIDE_D), dtype=np.float32)
        k = rng.standard_normal((b, cap, WIDE_KV, WIDE_D), dtype=np.float32)
        v = rng.standard_normal((b, cap, WIDE_KV, WIDE_D), dtype=np.float32)
        if kernel == "paged":
            tables = np.arange(b, dtype=np.int32)[:, None]
            args = [t(a).to(cuda_device, bf) for a in (q, k, v)] + [
                t(a).to(cuda_device) for a in (tables, pos)]
            fn, plain = paged_decode_attention, paged_decode_attention_plain
        else:
            args = [t(a).to(cuda_device, bf) for a in (q, k, v)] + [
                t(pos).to(cuda_device)]
            fn, plain = dense_decode_attention, dense_decode_attention_plain
        name = f"{kernel}_decode_attention"
    n0 = _build.bodies[name]["cuda_core"]
    got = fn(*args, _body="cuda_core")
    assert _build.bodies[name]["cuda_core"] == n0 + 1
    _card_close(got, plain(*args), "bfloat16")


# ----------------------------------------------------------------------
# the contiguous flash form (csrc/flash_attention.cu)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype,hd,aligned,want", [
    ("bfloat16", 64, True, "wgmma"), ("bfloat16", 256, True, "mma"),
    ("bfloat16", 128, True, "wgmma"), ("bfloat16", 16, True, "mma"),
    ("bfloat16", 80, True, "mma"), ("bfloat16", 72, True, "cuda_core"),
    ("bfloat16", 192, True, "cuda_core"), ("bfloat16", 64, False,
                                           "cuda_core"),
    ("float32", 64, True, "cuda_core"), ("float32", 256, True, "cuda_core"),
    ("bfloat16", 32, True, "mma"), ("bfloat16", 256, False, "cuda_core"),
    ("float32", 64, False, "cuda_core"), ("float32", 128, True, "cuda_core"),
    ("bfloat16", 112, True, "wgmma"), ("bfloat16", 112, False, "cuda_core"),
    ("float32", 112, True, "cuda_core"),
])
def test_flash_body_rule(dtype, hd, aligned, want):
    """The contiguous form's wrapper names its body by ``flash_body``:
    the warp-specialised wgmma body for every bf16 launch of smollm-360m's
    train step (hd 64, on the model's aligned projections), of zamba2-7b's
    (hd 112, on the hd-128 body) and of llama-3.2-vision-90b's
    ``Model.prefill`` (hd 128), the tensor-core ``mma`` tiles at the other
    bf16 head dims they take (gemma3-12b's 256 among them), the CUDA-core
    body elsewhere: float32 always, and unaligned tensors.  The cross
    form's head dims stay 64 and 128."""
    dt = getattr(torch, dtype)
    assert flash_body(dt, hd, aligned) == want
    assert WGMMA_HD == (64, 112, 128)
    assert CROSS_WGMMA_HD == (64, 128)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [32, 64, 112, 128, 256])
def test_cross_body_rule(hd, dtype, aligned):
    """The cross form's body by ``cross_body``: ``wgmma`` for bf16 at hd
    64 and 128 (seamless-m4t-medium's and llama-3.2-vision-90b's cross
    reads) on aligned tensors, else ``prefill_body``'s choice: ``mma`` at
    the ragged test's hd 32 and at 112 (which the contiguous form's rule
    sends to ``wgmma``: the cross kernel has no hd-112 body) and 256,
    ``cuda_core`` for float32 and unaligned tensors (the card's f32
    streams stay the CPU's)."""
    dt = getattr(torch, dtype)
    got = cross_body(dt, hd, aligned)
    if dtype == "bfloat16" and aligned and hd in (64, 128):
        assert got == "wgmma"
    else:
        assert got == prefill_body(dt, hd, aligned)
        assert got == ("mma" if dtype == "bfloat16" and aligned
                       else "cuda_core")


def _cross_shares(n_keys: int, splits: int) -> list:
    """The key tiles [t0, t1) CTA r of a cross cluster takes
    (csrc/paged_cross_attention.cu): [r nt / splits, (r + 1) nt / splits)
    of nt = ceil(n_keys / 64)."""
    nt = -(-n_keys // 64)
    return [(r * nt // splits, (r + 1) * nt // splits)
            for r in range(splits)]


@pytest.mark.parametrize("c,h,kv,hd,n_keys", [
    (128, 64, 8, 128, 1601),     # llama-3.2-vision-90b's chunk
    (128, 16, 16, 64, 1024),     # seamless-m4t-medium's chunk
    (32, 64, 8, 128, 1601), (9, 6, 2, 64, 37), (128, 16, 16, 64, 100),
    (1, 8, 8, 128, 1), (128, 64, 8, 128, 64), (77, 12, 4, 64, 5000),
])
def test_cross_splits_cover_the_keys_and_fill_the_card(c, h, kv, hd,
                                                       n_keys):
    """The cross form's split across a cluster: a rule of (C, H, KV, hd,
    n_keys) alone (no B, bs or table among its arguments, so a batched
    row gets a one-row call's split and bits), at most one portable
    cluster, its clusters all on the card in one wave, and the most
    that leaves each CTA CROSS_MIN_TILES key tiles; its shares cover the
    key tiles of [0, n_keys) in order with no gap, no overlap and none
    empty.  At llama-3.2-vision-90b's chunk it fills the card (128 of 132
    SMs); at seamless-m4t-medium's the tile floor holds it to 2 (32
    CTAs), since the wave-filling 6 is slower than the mma body at
    Model.prefill's B 8."""
    import inspect
    assert list(inspect.signature(cross_splits).parameters) == [
        "c", "h", "kv", "hd", "n_keys"]
    splits = cross_splits(c, h, kv, hd, n_keys)
    nt = -(-n_keys // 64)
    units = -(-c // (WGMMA_ROWS // (h // kv))) * kv
    cap = max(s for s in range(1, min(DECODE_MAX_SPLITS, nt) + 1)
              if units <= WIDE_CLUSTERS[s] or s == 1)
    assert splits == min(cap, max(1, nt // CROSS_MIN_TILES))
    assert units <= WIDE_CLUSTERS[splits] or splits == 1
    assert splits == 1 or nt // splits >= CROSS_MIN_TILES
    shares = _cross_shares(n_keys, splits)
    assert all(t0 < t1 for t0, t1 in shares)
    covered = [t for t0, t1 in shares for t in range(t0, t1)]
    assert covered == list(range(nt))
    assert covered[-1] * 64 < n_keys <= nt * 64
    if (c, h, kv, hd, n_keys) == (128, 64, 8, 128, 1601):
        assert (splits, units * splits) == (2, 128)
    if (c, h, kv, hd, n_keys) == (128, 16, 16, 64, 1024):
        assert (splits, units * splits) == (2, 32)


@pytest.mark.parametrize("form", ["flash", "cross", "chunk", "ring"])
@pytest.mark.parametrize("hd", WGMMA_HD)
def test_wgmma_bodies_fit_the_shared_memory_a_block_may_use(hd, form):
    """The wgmma bodies' shared memory (``wgt::Cfg::kSmem``, mirrored by
    ``wgmma_smem_bytes``) within the 232,448 bytes a block may use: Q's
    128 rows of the body's head dim, the K/V ring (4 stages of 64-key
    tiles but the contiguous form's 3 of 128 at hd 64) and the barriers;
    the split forms' f32 partial rows (O, m, l, 16-byte rows) fit their
    ring.  hd 112 runs on the hd-128 body's shared memory and key tiles in
    the contiguous form and the chunk forms (the paged chunk, ``chunk``,
    and the window form, ``ring``); the cross form's rule never names
    wgmma there."""
    if (form, hd) == ("cross", 112):
        assert hd not in CROSS_WGMMA_HD
        assert cross_body(torch.bfloat16, hd) == "mma"
        return
    width = 64 if hd == 64 else 128
    smem = wgmma_smem_bytes(hd, form)
    assert smem <= SMEM_PER_BLOCK
    assert smem == {("flash", 64): 115968}.get(
        (form, hd), {64: 83200, 128: 165120}[width])
    if form != "flash":                 # the partial rows reuse the ring
        assert smem == 1024 + 128 * width * 2 + 2 * 4 * 64 * width * 2 + 256
        assert WGMMA_ROWS * (width + 4) * 4 <= 2 * 4 * 64 * width * 2
    assert wgmma_tile_keys(hd, form) == (128 if (form, hd) == ("flash", 64)
                                         else 64)


@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128, 256])
def test_serving_forms_keep_their_bodies(hd):
    """The serving forms' rules each name only bodies their kernels take:
    the paged chunk (one-row and batched, ``chunk_body``) and the window
    form (``ring_body``) take ``wgmma`` in bf16 at hd 64, 112 and 128 and
    keep ``mma`` at the other head dims the tensor-core tiles take (16,
    32, gemma3-12b's 256), ``cuda_core`` in f32; ``prefill_body``, the
    base of every rule, never names ``wgmma``, so ``cross_body`` keeps
    ``mma`` at hd 112, which the cross kernel has no body for."""
    bf, f32 = torch.bfloat16, torch.float32
    wg = hd in (64, 112, 128)
    assert prefill_body(bf, hd) == "mma"
    assert chunk_body(bf, hd) == ("wgmma" if wg else "mma")
    assert ring_body(bf, hd) == ("wgmma" if wg else "mma")
    assert cross_body(bf, hd) == ("wgmma" if hd in (64, 128) else "mma")
    for rule in (prefill_body, ring_body, cross_body):
        assert rule(f32, hd) == "cuda_core"
    assert chunk_body(f32, hd) == "cuda_core"
    assert CHUNK_WGMMA_HD == RING_WGMMA_HD == WGMMA_HD == (64, 112, 128)


#: the served chunk shapes of the two chunk forms (C, H, KV, hd, capacity
#: or w) and the split each takes: smollm-360m's prefill (G 3: 4 row
#: tiles x 5 KV heads), zamba2-7b's hd-112 chunk (G 1), the hd-128 G-8
#: chunk of llama-3.2-vision-90b / qwen2-72b / command-r-35b,
#: seamless-m4t-medium's decoder self-attention (G 1 of 64), the verify
#: rounds (C 5) of smollm-360m and qwen2-72b; mixtral-8x7b's window form
SERVED_CHUNKS = [("chunk", 128, 15, 5, 64, 1024, 4),
                 ("chunk", 128, 32, 32, 112, 2176, 3),
                 ("chunk", 128, 64, 8, 128, 1152, 2),
                 ("chunk", 128, 16, 16, 64, 1024, 4),
                 ("chunk", 5, 15, 5, 64, 1024, 2),
                 ("chunk", 5, 64, 8, 128, 1024, 2),
                 ("ring", 128, 32, 8, 128, 4096, 3)]


@pytest.mark.parametrize("form,c,h,kv,hd,span,want", SERVED_CHUNKS + [
    ("chunk", 1, 15, 5, 64, 1024, None), ("chunk", 77, 6, 2, 112, 48, None),
    ("chunk", 128, 64, 8, 128, 64, None), ("ring", 33, 4, 4, 64, 48, None),
    ("ring", 160, 16, 8, 128, 128, None), ("ring", 5, 6, 2, 112, 32, None),
    ("chunk", 128, 200, 1, 64, 1024, None)])
def test_chunk_splits_cover_the_keys_and_fill_the_card(form, c, h, kv, hd,
                                                       span, want):
    """The chunk forms' wgmma split (``chunk_splits`` over the capacity,
    ``ring_splits``' wgmma branch over a full ring plus a whole chunk): a
    rule of shapes alone (no B, pos, bs or table among its arguments, so a
    batched row gets a one-row call's split and bits), at most one
    portable cluster, its clusters all on the card in one wave
    (``WIDE_CLUSTERS``), and the most that leaves each CTA
    CHUNK_MIN_TILES key tiles (a paged chunk of at most CHUNK_SHORT_C
    queries, the verify round's, at most CHUNK_SHORT_SPLITS); the shares
    a CTA cuts from the tiles it derives from pos cover them in order with
    no gap or overlap at every count of tiles."""
    import inspect
    if form == "chunk":
        assert list(inspect.signature(chunk_splits).parameters) == [
            "c", "h", "kv", "hd", "capacity"]
        splits = chunk_splits(c, h, kv, hd, span)
        nt = -(-span // 64)
    else:
        assert list(inspect.signature(ring_splits).parameters) == [
            "c", "h", "kv", "hd", "w", "body"]
        splits = ring_splits(c, h, kv, hd, span, "wgmma")
        nt = -(-span // 64) + -(-c // 64)
    units = -(-c // max(1, WGMMA_ROWS // (h // kv))) * kv
    cap = max(s for s in range(1, min(DECODE_MAX_SPLITS, nt) + 1)
              if units <= WIDE_CLUSTERS[s] or s == 1)
    most = min(cap, max(1, nt // CHUNK_MIN_TILES))
    if form == "chunk" and c <= CHUNK_SHORT_C:   # B rows fill the card
        most = min(most, CHUNK_SHORT_SPLITS)
    assert splits == most
    assert units <= WIDE_CLUSTERS[splits] or splits == 1
    assert splits == 1 or nt // splits >= CHUNK_MIN_TILES
    if want is not None:
        assert splits == want
    for n in range(1, nt + 1):
        shares = [(r * n // splits, (r + 1) * n // splits)
                  for r in range(splits)]
        assert [t for t0, t1 in shares for t in range(t0, t1)] == list(
            range(n))


def _wgmma_cta_tiles(form, pos, c, g, q0, nq, cap, w):
    """A CTA's key tiles in csrc/chunk_wgmma.cu (the kernel's arithmetic,
    mirrored): (tiles nt, ring tiles nrt, chunk key offset koff, slots
    read) for the CTA whose first query is q0."""
    rows = min(nq, c - q0) * g
    q_last = q0 + (rows - 1) // g
    if form == "ring":
        slots = min(pos, w)
        nrt = -(-slots // 64) if q0 < w else 0
        c_lo = max(0, q0 - w + 1) // 64
        return nrt + q_last // 64 - c_lo + 1, nrt, (nrt - c_lo) * 64, slots
    slots = min(pos + q_last, cap) + 1
    nt = -(-slots // 64)
    return nt, nt, 0, slots


def _wgmma_decisions(form, pos, q0, g, rows, nrt, koff, slots, cap, w,
                     wgi):
    """Warpgroup wgi's seen(t), masked(k0) and hidden(key, qi) in
    csrc/chunk_wgmma.cu, mirrored, and its live rows' queries."""
    rlo = 64 * wgi
    live = rlo < rows
    wq_first = q0 + rlo // g
    wq_last = q0 + min(rlo + 63, rows - 1) // g
    queries = sorted({q0 + r // g for r in range(rlo, min(rlo + 64, rows))})
    if form == "ring":
        pos_mod, ring_keys = pos % w, nrt * 64

        def seen(t):
            if not live:
                return False
            if t < nrt:
                return wq_first < w
            i0 = t * 64 - koff
            return i0 <= wq_last and i0 + 63 > wq_first - w

        def masked(k0):
            if k0 < ring_keys:
                n = min(64, slots - k0)
                d0 = (k0 - pos_mod) % w
                return n < 64 or d0 + n - 1 >= w or d0 <= wq_last
            i0 = k0 - koff
            return i0 + 63 > wq_first or i0 <= wq_last - w

        def hidden(key, qi):
            if key < ring_keys:
                return key >= slots or (key - pos_mod) % w <= qi
            i = key - koff
            return i > qi or i <= qi - w

        def visible(key, qi):            # the plain version's mask
            if key < ring_keys:
                return key < slots and (key - pos) % w > qi
            i = key - koff
            return qi - w < i <= qi
    else:
        k_first, k_last = min(pos + wq_first, cap), min(pos + wq_last, cap)

        def seen(t):
            return live and t * 64 <= k_last

        def masked(k0):
            return k0 + 63 > k_first

        def hidden(key, qi):
            return key > min(pos + qi, cap)

        def visible(key, qi):
            return key <= min(pos + qi, cap)
    return seen, masked, hidden, visible, queries


@pytest.mark.parametrize("form,c,h,kv,span", [
    ("chunk", 128, 15, 5, 1024), ("chunk", 128, 32, 32, 2176),
    ("chunk", 128, 64, 8, 1152), ("chunk", 5, 64, 8, 1024),
    ("chunk", 100, 15, 5, 512), ("chunk", 77, 6, 2, 48),
    ("ring", 128, 32, 8, 4096), ("ring", 64, 6, 2, 32),
    ("ring", 33, 4, 4, 48), ("ring", 160, 16, 8, 128),
    ("ring", 200, 4, 4, 96), ("ring", 5, 6, 2, 32)])
def test_chunk_wgmma_tiles_hand_every_key_to_one_cta(form, c, h, kv, span):
    """The chunk forms' wgmma body, its tile arithmetic mirrored: at every
    pos (0, inside the first lap, w - 1, w and far past it for the window
    form; past the capacity's clamp for the paged chunk), each key a row
    of a row tile sees lies in exactly one CTA's share of the cluster;
    each consumer warpgroup's seen tiles are one run (``Consumer::run``
    computes one run); a tile it skips holds no key any of its rows sees;
    a tile it leaves unmasked holds only keys all its rows see; on a
    masked tile the mask is the plain version's."""
    g = h // kv
    nq = WGMMA_ROWS // g
    hd = 64
    splits = (chunk_splits(c, h, kv, hd, span) if form == "chunk"
              else ring_splits(c, h, kv, hd, span, "wgmma"))
    cap, w = span - 1, span
    poss = ((0, 1, span // 2, span - c, span - 1, span + 37)
            if form == "chunk" else
            (0, 5, span // 2, span - 1, span, span + 7, 3 * span + 100))
    for pos in poss:
        pos = max(0, pos)
        for q0 in range(0, c, nq):
            rows = min(nq, c - q0) * g
            nt, nrt, koff, slots = _wgmma_cta_tiles(form, pos, c, g, q0, nq,
                                                    cap, w)
            shares = [range(r * nt // splits, (r + 1) * nt // splits)
                      for r in range(splits)]
            assert [t for sh in shares for t in sh] == list(range(nt))
            for wgi in range(2):
                seen, masked, hidden, visible, queries = _wgmma_decisions(
                    form, pos, q0, g, rows, nrt, koff, slots, cap, w, wgi)
                for sh in shares:
                    flags = [seen(t) for t in sh]
                    runs = sum(1 for i, f in enumerate(flags)
                               if f and (i == 0 or not flags[i - 1]))
                    assert runs <= 1
                    for t in sh:
                        keys = range(t * 64, t * 64 + 64)
                        vis = [[visible(k, qi) for k in keys]
                               for qi in queries]
                        if not seen(t):
                            assert not any(map(any, vis))
                        elif not masked(t * 64):
                            assert all(map(all, vis))
                        else:
                            assert vis == [[not hidden(k, qi) for k in keys]
                                           for qi in queries]
            # every key a row sees lies in a tile of [0, nt)
            for qi in range(q0, q0 + rows // g):
                if form == "ring":
                    need = ([j for j in range(slots) if (j - pos) % w > qi]
                            if nrt else [])
                    assert all(j < nrt * 64 for j in need)
                    assert all(0 <= i + koff < nt * 64
                               for i in range(max(0, qi - w + 1), qi + 1))
                else:
                    assert min(pos + qi, cap) < nt * 64


@pytest.mark.parametrize("dtype,hd,aligned,segments,want", [
    ("bfloat16", 64, True, True, "wgmma"),    # smollm-360m, seamless
    ("bfloat16", 112, True, True, "wgmma"),   # zamba2-7b
    ("bfloat16", 128, True, True, "wgmma"),   # vision / qwen2 / command-r
    ("bfloat16", 64, True, False, "mma"),     # blocks of 5 slots
    ("bfloat16", 128, True, False, "mma"),
    ("bfloat16", 64, False, True, "cuda_core"),
    ("bfloat16", 256, True, True, "mma"),     # gemma3-12b
    ("bfloat16", 96, True, True, "mma"),      # off the wgmma bodies
    ("bfloat16", 32, True, True, "mma"),
    ("bfloat16", 72, True, True, "cuda_core"),
    ("float32", 64, True, True, "cuda_core"),
    ("float32", 112, True, True, "cuda_core"),
    ("float32", 256, True, True, "cuda_core"),
])
def test_chunk_body_rule(dtype, hd, aligned, segments, want):
    """The paged chunk's body by ``chunk_body`` (the one-row prefill's
    and the batched form's, so a batched row keeps a one-row call's
    bits): ``wgmma`` in bf16 at hd 64, 112 and 128 on aligned tensors
    whose blocks cut into 8-slot TMA segments, at every chunk length
    (the verify round's C 5 too), else ``prefill_body``'s choice."""
    import inspect
    assert list(inspect.signature(chunk_body).parameters) == [
        "dtype", "hd", "aligned", "segments"]
    dt = getattr(torch, dtype)
    assert chunk_body(dt, hd, aligned, segments) == want
    if want != "wgmma":
        assert want == prefill_body(dt, hd, aligned)


# (B, H, KV, S, hd, causal, window): smollm-360m's heads, causal and
# ragged; the encoder's non-causal form with a window it must ignore;
# a window shorter than S at G 2; gemma3-12b's hd 256 with its window
# cut to the shape; hd 32 and 80 (other k16 counts)
FLASH_CARD_CASES = [(2, 15, 5, 512, 64, True, 0),
                    (2, 15, 5, 300, 64, True, 0),
                    (2, 6, 2, 1000, 64, False, 100),
                    (1, 4, 2, 700, 64, True, 128),
                    (1, 16, 8, 600, 256, True, 256),
                    (1, 4, 4, 130, 32, True, 0),
                    (2, 6, 3, 200, 80, False, 0)]
FLASH_LSE_TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def _flash_card_inputs(cuda_device, seed, b, h, kv, s, d, dt):
    rng = np.random.default_rng(seed)
    return [t(rng.standard_normal(shape, dtype=np.float32)).to(cuda_device,
                                                                dt)
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,d,causal,window", FLASH_CARD_CASES)
def test_cuda_flash_matches_plain(cuda_device, dtype, b, h, kv, s, d,
                                  causal, window):
    """The contiguous kernel against its plain version on the card, out
    and row log-sum-exp, one launch counted on the body ``flash_body``
    names; bf16 forced onto ``cuda_core`` too, and onto ``mma`` where the
    rule names ``wgmma``."""
    dt = getattr(torch, dtype)
    q, k, v = _flash_card_inputs(cuda_device, 90, b, h, kv, s, d, dt)
    body = flash_body(dt, d)
    n0 = _build.bodies["flash_attention"][body]
    out, lse = flash_attention(q, k, v, causal=causal, window=window)
    assert _build.bodies["flash_attention"][body] == n0 + 1
    want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
    assert out.dtype == dt and lse.dtype == torch.float32
    assert torch.isfinite(out.float()).all()
    _card_close(out, want, dtype)
    assert _err(lse.cpu(), want_lse.cpu()) <= FLASH_LSE_TOL[dtype]
    if dtype == "bfloat16":
        for other in ("cuda_core",) + (("mma",) if body == "wgmma" else ()):
            out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                       _body=other)
            _card_close(out, want, dtype)
            assert _err(lse.cpu(), want_lse.cpu()) <= FLASH_LSE_TOL[dtype]


# (B, H, KV, S, causal, window) at hd 64, the wgmma body's edges: S of 1,
# 127, 129 and 4095 (a key tile and a row tile cut short, one past);
# G 1, 3, 4, 8 and 16 (whole queries a CTA: 128, 42, 32, 16, 8); a
# window shorter than a key tile; B 8; non-causal and ragged
WGMMA_CARD_CASES = [(1, 3, 1, 1, True, 0), (1, 3, 1, 1, False, 0),
                    (2, 4, 4, 127, True, 0), (2, 12, 3, 129, True, 0),
                    (1, 8, 1, 4095, True, 0), (8, 15, 5, 256, True, 0),
                    (1, 6, 2, 700, True, 40), (2, 6, 2, 333, False, 0),
                    (1, 16, 1, 300, True, 0), (2, 15, 5, 1000, True, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,causal,window", WGMMA_CARD_CASES)
def test_cuda_flash_wgmma_matches_plain(cuda_device, b, h, kv, s, causal,
                                        window):
    """The wgmma body (the rule's at bf16 hd 64) and the ``mma`` body
    forced through ``_body``, each against the plain version on the
    card, out under the bf16 gate and the row log-sum-exp within
    FLASH_LSE_TOL, each launch counted on its body."""
    q, k, v = _flash_card_inputs(cuda_device, 94, b, h, kv, s, 64,
                                 torch.bfloat16)
    want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
    assert flash_body(torch.bfloat16, 64) == "wgmma"
    for body in ("wgmma", "mma"):
        n0 = _build.bodies["flash_attention"][body]
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   _body=None if body == "wgmma" else body)
        assert _build.bodies["flash_attention"][body] == n0 + 1
        assert torch.isfinite(out.float()).all()
        _card_close(out, want, "bfloat16")
        assert _err(lse.cpu(), want_lse.cpu()) <= FLASH_LSE_TOL["bfloat16"]


@pytest.mark.cuda
def test_cuda_flash_wgmma_refuses_what_it_cannot_take(cuda_device):
    """Forced onto a shape the wgmma body does not take (hd 32 and 256,
    float32 at every hd it takes, 112 among them, more heads a group than
    its rows), the launch raises; nothing runs on another body."""
    before = dict(_build.bodies["flash_attention"])
    for d in (32, 256):
        q, k, v = _flash_card_inputs(cuda_device, 95, 1, 4, 2, 64, d,
                                     torch.bfloat16)
        with pytest.raises(RuntimeError):
            flash_attention(q, k, v, _body="wgmma")
    for d in WGMMA_HD:
        q, k, v = _flash_card_inputs(cuda_device, 95, 1, 4, 2, 64, d,
                                     torch.float32)
        with pytest.raises(RuntimeError):
            flash_attention(q, k, v, _body="wgmma")
    g = WGMMA_ROWS + 1
    q, k, v = _flash_card_inputs(cuda_device, 95, 1, g, 1, 8, 64,
                                 torch.bfloat16)
    with pytest.raises(RuntimeError):
        flash_attention(q, k, v)
    torch.cuda.synchronize()
    after = _build.bodies["flash_attention"]
    assert {k: after[k] - before[k] for k in after} == {
        "wgmma": 6, "mma": 0, "cuda_core": 0}


# (B, H, KV, S, causal, window) at hd 128 and 112: G 1, 4 and 8 (whole
# queries a CTA: 128, 32, 16); S 100 and 1000, off the 64-key tiles and
# the row tiles; causal, non-causal and a window; llama-3.2-vision-90b's
# Model.prefill shape (B 8, S 128, 64 / 8 heads); zamba2-7b's heads (32 /
# 32, G 1) at S 700
WGMMA128_CARD_CASES = [(2, 4, 4, 100, True, 0), (1, 8, 2, 1000, True, 0),
                       (2, 16, 2, 1000, False, 0), (1, 8, 1, 100, False, 0),
                       (1, 8, 2, 1000, True, 300), (2, 4, 1, 1000, True, 40),
                       (8, 64, 8, 128, True, 0), (2, 32, 32, 700, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 112])
@pytest.mark.parametrize("b,h,kv,s,causal,window", WGMMA128_CARD_CASES)
def test_cuda_flash_wgmma_hd128_matches_plain(cuda_device, b, h, kv, s,
                                              causal, window, d):
    """The wgmma body at hd 128, and at 112 on the same body (the last 16
    columns zero-filled by TMA, never stored), the rule's at bf16, and
    the ``mma`` body forced through ``_body``, each against the plain
    version on the card, out under the bf16 gate and the row
    log-sum-exp within FLASH_LSE_TOL, each launch counted on its body."""
    q, k, v = _flash_card_inputs(cuda_device, 96, b, h, kv, s, d,
                                 torch.bfloat16)
    want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
    assert flash_body(torch.bfloat16, d) == "wgmma"
    for body in ("wgmma", "mma"):
        n0 = _build.bodies["flash_attention"][body]
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   _body=None if body == "wgmma" else body)
        assert _build.bodies["flash_attention"][body] == n0 + 1
        assert torch.isfinite(out.float()).all()
        _card_close(out, want, "bfloat16")
        assert _err(lse.cpu(), want_lse.cpu()) <= FLASH_LSE_TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 112])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_reads_the_model_layout_in_place(cuda_device, dtype, d):
    """The model's (B, S, heads, hd) projections, passed as transposed
    views, give the bits of contiguous (B, heads, S, hd) copies, and the
    output takes q's layout (so the O product reads it without a copy):
    on the rule's body (bf16: wgmma, at hd 112 through tensor maps over
    224-byte rows) and, in bf16, on ``mma`` too."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(91)
    b, s, h, kv = 2, 333, 15, 5
    q = t(rng.standard_normal((b, s, h, d), dtype=np.float32)).to(
        cuda_device, dt)
    k, v = (t(rng.standard_normal((b, s, kv, d), dtype=np.float32)).to(
        cuda_device, dt) for _ in range(2))
    views = [a.transpose(1, 2) for a in (q, k, v)]
    for body in ((None, "mma") if dtype == "bfloat16" else (None,)):
        out, lse = flash_attention(*views, _body=body)
        assert out.transpose(1, 2).is_contiguous()
        ref_out, ref_lse = flash_attention(*[a.contiguous() for a in views],
                                           _body=body)
        assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 112])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100),
                                           (False, 0)])
def test_cuda_flash_fn_gradients(cuda_device, dtype, causal, window, d):
    """FlashAttentionFn's dq, dk, dv on the card (the kernel's forward,
    the torch-op backward) against autograd through the plain version on
    the card, at B 2, S 512, smollm-360m's heads at hd 64 and at
    zamba2-7b's 112: float32 within 2e-5 of max(1, |g|), bfloat16 within
    2e-2 of it (the two forwards' outputs round once each): on the rule's
    body (bf16: wgmma) and, in bf16, on ``mma`` too."""
    dt = getattr(torch, dtype)
    q, k, v = _flash_card_inputs(cuda_device, 92, 2, 15, 5, 512, d, dt)
    w = _flash_card_inputs(cuda_device, 93, 2, 15, 5, 512, d, dt)[0]
    p = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad((flash_attention_plain(
        *p, causal=causal, window=window)[0].float() * w.float()).sum(), p)
    for body in ((None, "mma") if dtype == "bfloat16" else (None,)):
        n0 = _build.bodies["flash_attention"][body or flash_body(dt, d)]
        a = [x.clone().requires_grad_(True) for x in (q, k, v)]
        got = torch.autograd.grad((FlashAttentionFn.apply(
            *a, causal, window, None, body).float() * w.float()).sum(), a)
        assert _build.bodies["flash_attention"][
            body or flash_body(dt, d)] == n0 + 1
        for g, r in zip(got, want):
            assert g.dtype == dt
            diff = (g.float() - r.float()).abs() / r.float().abs().clamp(
                min=1)
            assert diff.max().item() <= CARD_TOL[dtype]
