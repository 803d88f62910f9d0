"""The port's dry-run (``repro_torch.launch.dryrun``, ``hlo_analysis``)
and the kernels' fake branch, against the JAX package's.

* the collective counter's row against ``repro.launch.hlo_analysis``'s
  HLO parser over the same five collectives;
* the roofline functions against the reference's, its TPU constants
  replaced by the port's H100 ones;
* ``dryrun_one`` at full size on the production meshes of a fake
  process group, each
  cell's per-device FLOPs times its chips against the same step on a
  1x1 mesh;
* every kernel wrapper's fake branch: the plain version's shapes and
  dtypes, and the matrix products of the reference's oracle
  (``repro/kernels/ref.py``'s jaxpr) or, for a form with no oracle
  there, of its plain version (the reference's jnp path, op for op).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from _torch_jaxpr import dot_flops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as port  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore")


@pytest.fixture(scope="module")
def world():
    """The fake world of 512 ranks for this module (a process group a
    test before left up is closed first), closed after it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    dryrun.fake_world()
    yield
    dryrun._MESHES.clear()
    dist.destroy_process_group()


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------
HLO = """
  %ag = f32[64,8]{1,0} all-gather(f32[4,8]{1,0} %a), dimensions={0}
  %ar = bf16[32,8]{1,0} all-reduce(bf16[32,8]{1,0} %b), to_apply=%add
  %rs = f32[4,8]{1,0} reduce-scatter(f32[64,8]{1,0} %c), dimensions={0}
  %aa = s32[16,4]{1,0} all-to-all(s32[16,4]{1,0} %d), dimensions={0}
  %cp = f32[2,3]{1,0} collective-permute(f32[2,3]{1,0} %e), source_target_pairs={{0,1}}
  %nop = f32[2]{0} add(f32[2]{0} %x, f32[2]{0} %y)
"""


def test_collective_row_equals_reference_parser(world):
    """One collective of each kind on a fake group of 16 under the
    port's recorder: its row is the reference parser's over HLO with the
    same five instructions and result shapes, key for key."""
    import torch.distributed._functional_collectives as funcol
    from repro.launch.hlo_analysis import collective_stats
    group = dist.new_group(list(range(16)))
    with port.StepRecorder() as rec:
        funcol.all_gather_tensor(torch.zeros(4, 8), 0, group).wait()
        funcol.all_reduce(torch.zeros(32, 8, dtype=torch.bfloat16), "sum",
                          group).wait()
        funcol.reduce_scatter_tensor(torch.zeros(64, 8), "sum", 0,
                                     group).wait()
        funcol.all_to_all_single(torch.zeros(16, 4, dtype=torch.int32),
                                 None, None, group).wait()
        dist.send(torch.zeros(2, 3), dst=1, group=group)
    want = collective_stats(HLO).row()
    assert rec.collectives.row() == want
    assert all(want[f"{k}_count"] == 1 for k in port._COLLECTIVES)


# ----------------------------------------------------------------------
# roofline
# ----------------------------------------------------------------------
def test_roofline_functions_equal_reference(monkeypatch):
    """``roofline_terms``, ``mfu`` and ``mbu`` are the reference's with
    its module constants set to the port's (the H100's spec sheet)."""
    from repro.launch import hlo_analysis as ref
    monkeypatch.setattr(ref, "PEAK_FLOPS_BF16", port.PEAK_FLOPS_BF16)
    monkeypatch.setattr(ref, "HBM_BW", port.HBM_BW)
    monkeypatch.setattr(ref, "ICI_BW_PER_LINK", port.NVLINK_BW)
    rng = np.random.default_rng(0)
    for _ in range(20):
        f, b, c = (float(10 ** x) for x in rng.uniform(6, 16, 3))
        n = int(rng.integers(1, 513))
        assert port.roofline_terms(f, b, c, n) == ref.roofline_terms(
            f, b, c, n)
        assert port.mfu(f, b) == ref.mfu(f, b)
        assert port.mbu(b, c) == ref.mbu(b, c)
    assert port.PEAK_FLOPS_BF16 == 989.4e12
    assert port.HBM_BW == 3.35e12 and port.NVLINK_BW == 450e9


@pytest.mark.parametrize("flops, hbm, coll, dominant", [
    (1e15, 1e9, 1e6, "compute"), (1e9, 1e13, 1e6, "memory")])
def test_roofline_terms_dominance(flops, hbm, coll, dominant):
    """The reference test's two dominance cases."""
    assert port.roofline_terms(flops=flops, hbm_bytes=hbm, coll_bytes=coll,
                               n_chips=256)["dominant"] == dominant


# ----------------------------------------------------------------------
# dryrun_one at full size
# ----------------------------------------------------------------------
REF_KEYS = ("arch", "shape", "mesh", "layout", "status", "flops",
            "hbm_bytes", "n_chips", "compile_s", "argument_bytes",
            "output_bytes", "temp_bytes", "peak_bytes", "collective_bytes",
            "t_compute_s", "t_memory_s", "t_collective_s", "dominant") + tuple(
    f"{k}_{x}" for k in port._COLLECTIVES for x in ("bytes", "count"))


FULL_SIZE = [("smollm-360m", "train_4k", False),
             ("mixtral-8x7b", "decode_32k", True),
             ("falcon-mamba-7b", "long_500k", False)]
#: per-device FLOPs x chips of each FULL_SIZE cell, for the 1x1 test
_PRODUCTION: dict = {}


@pytest.mark.parametrize("arch, shape, multi", FULL_SIZE)
def test_dryrun_one_full_size(world, arch, shape, multi):
    """A cell on a production mesh: status ``ok`` with every key of the
    reference's record."""
    rec = dryrun.dryrun_one(arch, shape, multi, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(REF_KEYS) <= set(rec)
    assert rec["n_chips"] == (512 if multi else 256)
    assert rec["flops"] > 0 and rec["hbm_bytes"] > 0
    assert rec["peak_bytes"] == rec["argument_bytes"] + rec["temp_bytes"]
    _PRODUCTION[arch, shape, multi] = rec["flops"] * rec["n_chips"]


@pytest.mark.parametrize("arch, shape, multi", FULL_SIZE)
def test_dryrun_flops_no_less_than_one_device(world, arch, shape, multi):
    """The cell's per-device FLOPs times its chips is no less than the
    same step's on a 1x1 mesh (sharding only adds work: a replicated
    head or a gathered token is counted on every rank); the ratio is
    printed."""
    from repro_torch.config import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    if (arch, shape, multi) not in _PRODUCTION:
        test_dryrun_one_full_size(world, arch, shape, multi)
    one = dryrun.measure(get_config(arch), SHAPES[shape],
                         make_host_mesh(dryrun.DEVICE))
    assert one["status"] == "ok"
    assert one["collective_bytes"] == 0 and one["n_chips"] == 1
    ratio = _PRODUCTION[arch, shape, multi] / one["flops"]
    print(f"{arch} {shape}: flops x chips / 1x1 = {ratio:.4f}")
    assert ratio >= 1.0


def test_dryrun_one_skips_by_the_reference_rule():
    rec = dryrun.dryrun_one("smollm-360m", "long_500k", False, verbose=False)
    assert rec == {"arch": "smollm-360m", "shape": "long_500k",
                   "mesh": "16x16", "layout": "heads",
                   "status": "skipped(DESIGN.md rule)"}


# ----------------------------------------------------------------------
# the kernels' fake branch
# ----------------------------------------------------------------------
def _real(shape, dtype=torch.float32, lo=None, hi=None, seed=0):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return torch.from_numpy(rng.integers(lo, hi, shape)).to(dtype)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(dtype)


def _kernel_cases():
    """(name, wrapper call, plain call, inputs, reference FLOPs or None
    for the plain version's, ...)."""
    from repro.kernels import ref
    from repro_torch.kernels import (decode_attention as da,
                                     flash_attention as fa,
                                     quant_matmul as qm, rmsnorm as rn,
                                     selective_scan as ss)
    B, H, KV, S, HD, NB, BS = 2, 4, 2, 16, 8, 6, 4
    q3, q4 = _real((B, H, HD)), _real((B, H, S, HD))
    kv4 = _real((B, KV, S, HD), seed=1)
    cache = _real((B, S, KV, HD), seed=2)
    pool = _real((NB, BS, KV, HD), seed=3)
    tables = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    pos = torch.tensor([7, 10], dtype=torch.int32)
    qc = _real((B, 5, H, HD), seed=4)
    j = lambda f, *a: dot_flops(jax.make_jaxpr(f)(*a))  # noqa: E731
    z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
    cases = [
        ("flash causal", lambda *a: fa.flash_attention(*a, causal=True),
         lambda *a: fa.flash_attention_plain(*a, causal=True),
         (q4, kv4, kv4), j(lambda q, k, v: ref.flash_attention_ref(
             q, k, v, causal=True), z(B, H, S, HD), z(B, KV, S, HD),
             z(B, KV, S, HD))),
        ("flash window", lambda *a: fa.flash_attention(*a, window=5),
         lambda *a: fa.flash_attention_plain(*a, window=5),
         (q4, kv4, kv4), j(lambda q, k, v: ref.flash_attention_ref(
             q, k, v, window=5), z(B, H, S, HD), z(B, KV, S, HD),
             z(B, KV, S, HD))),
        ("flash encoder", lambda *a: fa.flash_attention(*a, causal=False),
         lambda *a: fa.flash_attention_plain(*a, causal=False),
         (q4, kv4, kv4), j(lambda q, k, v: ref.flash_attention_ref(
             q, k, v, causal=False), z(B, H, S, HD), z(B, KV, S, HD),
             z(B, KV, S, HD))),
        ("dense decode", da.dense_decode_attention,
         da.dense_decode_attention_plain, (q3, cache, cache, pos),
         j(ref.decode_attention_ref, z(B, H, HD), z(B, KV, S, HD),
           z(B, KV, S, HD), jnp.zeros((B,), jnp.int32))),
        ("paged decode", da.paged_decode_attention,
         da.paged_decode_attention_plain, (q3, pool, pool, tables, pos),
         j(ref.paged_decode_attention_ref, z(B, H, HD), z(KV, NB, BS, HD),
           z(KV, NB, BS, HD), jnp.zeros((B, 3), jnp.int32),
           jnp.zeros((B,), jnp.int32))),
        ("dense decode partial",
         lambda *a: da.dense_decode_attention_partial(*a, 8),
         lambda *a: da.dense_decode_attention_partial_plain(*a, 8),
         (q3, cache, cache, pos), None),
        ("paged prefill", lambda *a: fa.paged_prefill_attention(*a, 3),
         lambda *a: fa.paged_prefill_attention_plain(*a, 3),
         (qc[0], pool, pool, tables[0]), None),
        ("paged chunk", fa.paged_chunk_attention,
         fa.paged_chunk_attention_plain, (qc, pool, pool, tables, pos),
         None),
        ("paged cross", lambda *a: fa.paged_cross_attention(*a, 9),
         lambda *a: fa.paged_cross_attention_plain(*a, 9),
         (qc, pool, pool, tables), None),
        ("ring chunk", lambda *a: fa.ring_chunk_attention(*a, 11, 8),
         lambda *a: fa.ring_chunk_attention_plain(*a, 11, 8),
         (qc[0], pool, pool, tables[0], _real((5, KV, HD), seed=5),
          _real((5, KV, HD), seed=6)), None),
    ]
    x, sc = _real((3, 16)), _real((16,), seed=7)
    q8 = _real((16, 8), torch.int8, -127, 128)
    q4b = _real((8, 8), torch.uint8, 0, 256)
    s8, s4 = _real((1, 8)).abs(), _real((2, 8)).abs()
    cases += [
        ("quant int8", qm.quant_matmul_int8, qm.quant_matmul_int8_plain,
         (x, q8, s8), j(ref.quant_matmul_int8_ref, z(3, 16),
                        jnp.zeros((16, 8), jnp.int8), z(1, 8))),
        ("quant int4", qm.quant_matmul_int4, qm.quant_matmul_int4_plain,
         (x, q4b, s4), j(ref.quant_matmul_int4_ref, z(3, 16),
                         jnp.zeros((8, 8), jnp.uint8), z(2, 8))),
        ("rmsnorm", rn.rmsnorm, rn.rmsnorm_plain, (x, sc),
         j(ref.rmsnorm_ref, z(3, 16), z(16))),
        ("add_rmsnorm", rn.add_rmsnorm, rn.add_rmsnorm_plain,
         (x, _real((3, 16), seed=8), sc),
         j(lambda a, d, s: ref.rmsnorm_ref(a + d, s), z(3, 16), z(3, 16),
           z(16))),
    ]
    T, DI, DS = 5, 6, 3
    scan_in = (_real((B, T, DI)).abs(), _real((B, T, DS), seed=1),
               _real((B, T, DS), seed=2), _real((B, T, DI), seed=3),
               -_real((DI, DS), seed=4).abs(), _real((B, DI, DS), seed=5))
    ckpt = torch.zeros((B, ss.scan_checkpoints(T), DI, DS))
    ss.selective_scan_plain(*scan_in, checkpoints=ckpt)
    cases += [
        ("selective scan", ss.selective_scan, ss.selective_scan_plain,
         scan_in, j(ref.selective_scan_ref, z(B, T, DI), z(B, T, DS),
                    z(B, T, DS), z(B, T, DI), z(DI, DS), z(B, DI, DS))),
        ("selective scan backward", ss.selective_scan_backward,
         ss.selective_scan_backward_plain,
         scan_in[:5] + (ckpt, _real((B, T, DI), seed=9)), 0),
    ]
    return cases


CASES = {c[0]: c for c in _kernel_cases()}


def _leaves(out):
    return [out] if torch.is_tensor(out) else list(out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fake_branch(name):
    """The wrapper on fake tensors: outputs of the plain version's
    shapes and dtypes on real CPU inputs of the same shapes, on the fake
    tensors' device, and the matrix products of the reference's oracle
    (or of the plain version, the reference's jnp path op for op); the
    same wrapper on the real CPU tensors runs the plain version."""
    from torch.utils.flop_counter import FlopCounterMode
    _, wrapper, plain, inputs, want = CASES[name]
    real = _leaves(plain(*inputs))
    if want is None:
        with FlopCounterMode(display=False) as fc:
            plain(*inputs)
        want = fc.get_total_flops()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fakes = [mode.from_tensor(t) for t in inputs]
    with mode, port.StepRecorder() as rec:
        out = _leaves(wrapper(*fakes))
    assert [(tuple(o.shape), o.dtype) for o in out] == [
        (tuple(r.shape), r.dtype) for r in real]
    assert all(dryrun_is_fake(o) for o in out)
    assert rec.flops == want
    again = _leaves(wrapper(*inputs))
    assert all(torch.equal(a, b) for a, b in zip(again, real))


def dryrun_is_fake(t) -> bool:
    from repro_torch.kernels.fake import is_abstract
    return is_abstract(t)


def test_fake_ops_refuse_real_tensors():
    """The fake operators run on tensors without data only: a real
    tensor that reached one would raise (no wrapper sends it there)."""
    from repro_torch.kernels import fake
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(RuntimeError, match="fake tensors only"):
        fake.flash(q, q, q, True, 0)
    assert fake.attention_extent(8192, True, 0) == 4096 * 4096 + 4096 * 8192
    assert fake.attention_extent(4096, False, 0) == 4096 * 4096
