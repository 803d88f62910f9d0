"""The kernels on tensors that hold no data: the wrappers' fake branch.

Every wrapper in this package takes one branch before its device rule:
when its first input is a ``FakeTensor`` (under
``torch._subclasses.FakeTensorMode`` every input is one) it calls the
matching operator here and returns what that returns.  A tensor on the
``meta`` device is not one: it stands for a device the kernels do not
run on, and the wrappers refuse it as before.  Each operator is a
``torch.library`` custom op whose fake implementation gives the
kernel's outputs (shapes, dtypes and device) and launches nothing, and
whose FLOP formula
(``torch.utils.flop_counter.register_flop_formula``) is the matrix
products the reference's jnp path computes for the same call:

* the flash forms: Q K^T and P V over the extent jnp scores, the whole
  masked square up to ``Q_CHUNK`` queries and, past it, blocks of
  ``Q_CHUNK`` queries over the keys ``[k0, q1)`` a block may see (the
  reference's ``self_attention``); a chunk, a cross read and the ring
  form over every slot they score;
* the decodes: Q K^T and P V over the cache's slots;
* the quant matmuls: ``2 M N K``;
* the selective scan: ``y_t = sum_s h_t C_t`` a step, ``2 B T DI DS``
  (the reference's scan step and its oracle contract the state with
  ``einsum``);
* rmsnorm, and the scan's backward: none.

The dry-run (``launch/dryrun.py``) runs the port's steps on fake
tensors and reads these counts.  A real tensor never reaches this
module: on the CPU a wrapper runs its plain version, on the card it
launches its kernel or raises.  Nothing here is a fallback.
"""
from typing import Tuple

import torch
from torch import Tensor
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

#: the reference's query-block width for whole-sequence attention
#: (``repro/models/attention.py::Q_CHUNK``)
Q_CHUNK = 4096


def is_abstract(t) -> bool:
    """Is ``t`` (a wrapper's first tensor) a fake tensor: no data, under
    a fake mode?  One ``isinstance``: it runs before every launch."""
    return isinstance(t, FakeTensor)


def attention_extent(s: int, causal: bool, window: int) -> int:
    """Query-key pairs the reference's ``self_attention`` scores for a
    sequence of ``s``: ``s * s`` up to :data:`Q_CHUNK`, else the sum of
    its blocks' ``(q1 - q0) * (k1 - k0)``."""
    if s <= Q_CHUNK:
        return s * s
    total = 0
    for q0 in range(0, s, Q_CHUNK):
        q1 = min(q0 + Q_CHUNK, s)
        if causal:
            k0 = max(0, q0 - window + 1) if window else 0
            k1 = q1
        else:
            k0, k1 = 0, s
        total += (q1 - q0) * (k1 - k0)
    return total


def _unused(name):
    def impl(*args, **kwargs):
        raise RuntimeError(f"repro_torch::{name} runs on fake tensors "
                           f"only; real tensors take the kernel's wrapper")
    return impl


def _op(name: str, fake, flops=None):
    """The custom op ``repro_torch::<name>`` with ``fake`` as its fake
    implementation and ``flops`` (shapes -> FLOPs) as its formula."""
    op = torch.library.custom_op(f"repro_torch::{name}", mutates_args=(),
                                 schema=None)(_typed(fake, _unused(name)))
    op.register_fake(fake)
    if flops is not None:
        register_flop_formula(getattr(torch.ops.repro_torch, name))(
            lambda *a, out_shape=None, **kw: flops(*a, **kw))
    return op


def _typed(fake, impl):
    """``impl`` carrying ``fake``'s signature (custom_op infers the
    schema from the annotations)."""
    import functools
    return functools.wraps(fake)(impl)


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def _flash(q: Tensor, k: Tensor, v: Tensor, causal: bool,
           window: int) -> Tuple[Tensor, Tensor]:
    b, h, s, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, s), dtype=torch.float32))


def _flash_flops(q, k, v, causal, window):
    b, h, s, hd = q
    return 4 * b * h * attention_extent(s, causal, window) * hd


flash = _op("flash", _flash, _flash_flops)


def _paged_prefill(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                   table: Tensor) -> Tensor:
    return torch.empty_like(q)


def _paged_prefill_flops(q, k_pool, v_pool, table):
    c, h, hd = q
    return 4 * c * h * table[0] * k_pool[1] * hd


paged_prefill = _op("paged_prefill", _paged_prefill, _paged_prefill_flops)


def _paged_chunk(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                 tables: Tensor) -> Tensor:
    return torch.empty_like(q)


def _paged_chunk_flops(q, k_pool, v_pool, tables):
    b, c, h, hd = q
    return 4 * b * c * h * tables[1] * k_pool[1] * hd


paged_chunk = _op("paged_chunk", _paged_chunk, _paged_chunk_flops)


def _paged_cross(q: Tensor, k_pool: Tensor, v_pool: Tensor, tables: Tensor,
                 n_keys: int) -> Tensor:
    return torch.empty_like(q)


def _paged_cross_flops(q, k_pool, v_pool, tables, n_keys):
    b, c, h, hd = q
    return 4 * b * c * h * n_keys * hd


paged_cross = _op("paged_cross", _paged_cross, _paged_cross_flops)


def _ring_chunk(q: Tensor, k_pool: Tensor, v_pool: Tensor, table: Tensor,
                k_new: Tensor, v_new: Tensor, w: int) -> Tensor:
    return torch.empty_like(q)


def _ring_chunk_flops(q, k_pool, v_pool, table, k_new, v_new, w):
    c, h, hd = q
    return 4 * c * h * (w + c) * hd


ring_chunk = _op("ring_chunk", _ring_chunk, _ring_chunk_flops)


def _paged_decode(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                  tables: Tensor) -> Tensor:
    return torch.empty_like(q)


def _paged_decode_flops(q, k_pool, v_pool, tables):
    b, h, hd = q
    return 4 * b * h * tables[1] * k_pool[1] * hd


paged_decode = _op("paged_decode", _paged_decode, _paged_decode_flops)


def _dense_decode(q: Tensor, k_cache: Tensor, v_cache: Tensor) -> Tensor:
    return torch.empty_like(q)


def _dense_decode_flops(q, k_cache, v_cache):
    b, h, hd = q
    return 4 * b * h * k_cache[1] * hd


dense_decode = _op("dense_decode", _dense_decode, _dense_decode_flops)


def _dense_decode_partial(q: Tensor, k_cache: Tensor,
                          v_cache: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    b, h, hd = q.shape
    return (q.new_empty((b, h, hd), dtype=torch.float32),
            q.new_empty((b, h, 1), dtype=torch.float32),
            q.new_empty((b, h, 1), dtype=torch.float32))


dense_decode_partial = _op("dense_decode_partial", _dense_decode_partial,
                           _dense_decode_flops)


# ----------------------------------------------------------------------
# quant matmul
# ----------------------------------------------------------------------
def _quant_matmul(x: Tensor, q: Tensor, s: Tensor, k: int) -> Tensor:
    return x.new_empty((*x.shape[:-1], q.shape[-1]))


def _quant_matmul_flops(x, q, s, k):
    m = 1
    for d in x[:-1]:
        m *= d
    return 2 * m * q[-1] * k


quant_matmul = _op("quant_matmul", _quant_matmul, _quant_matmul_flops)


# ----------------------------------------------------------------------
# rmsnorm and the selective scan
# ----------------------------------------------------------------------
def _rmsnorm(x: Tensor, scale: Tensor) -> Tensor:
    return torch.empty_like(x)


rmsnorm = _op("rmsnorm", _rmsnorm)


def _add_rmsnorm(x: Tensor, delta: Tensor,
                 scale: Tensor) -> Tuple[Tensor, Tensor]:
    return torch.empty_like(x), torch.empty_like(x)


add_rmsnorm = _op("add_rmsnorm", _add_rmsnorm)


def _scan(dt: Tensor, b_mat: Tensor, c_mat: Tensor, x: Tensor,
          a_neg: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    return torch.empty_like(dt), torch.empty_like(h0, dtype=torch.float32)


def _scan_flops(dt, b_mat, c_mat, x, a_neg, h0):
    bsz, t, di = dt
    return 2 * bsz * t * di * a_neg[-1]


scan = _op("selective_scan", _scan, _scan_flops)


def _scan_backward(dt: Tensor, b_mat: Tensor, c_mat: Tensor, x: Tensor,
                   a_neg: Tensor, checkpoints: Tensor, dy: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                              Tensor]:
    bsz, t, di = dt.shape
    ds = a_neg.shape[-1]
    f32 = dict(dtype=torch.float32)
    return (dt.new_empty(dt.shape, **f32), dt.new_empty((bsz, t, ds), **f32),
            dt.new_empty((bsz, t, ds), **f32), dt.new_empty(dt.shape, **f32),
            dt.new_empty((di, ds), **f32), dt.new_empty((bsz, di, ds), **f32))


scan_backward = _op("selective_scan_backward", _scan_backward)
