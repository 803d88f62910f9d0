"""The port's weight quantization against the live JAX package.

``repro_torch.models.quantize`` packs weights as ``repro.models.quantize``
does, and the plain quant matmuls (what the wrappers run on the CPU)
compute what the Pallas kernel, the ``ref.py`` oracles and JAX's
``qdot`` compute, on the same numpy inputs.

Tolerances: packed ints are equal and scales equal within one f32 ulp
(both sides round half to even after one IEEE division).  The matmuls
agree within 1e-4 at unit scale: the weights are drawn N(0, 1/K), so
outputs are of order one, and the plain versions sum the reference's
K-chunks in its order (``_chunk_len``), leaving only the order inside
one chunk's dot, ~1e-6 at K <= 2560.  ``tests/test_quant_matmul.py``
states 1e-3 for N(0, 1) weights, whose outputs are sqrt(K) times
larger; 1e-4 here still fails a wrong scale, nibble or group by orders
of magnitude.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_ref import bridged, config_pair, jax_params, t  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.quant_matmul import quant_matmul_pallas  # noqa: E402
from repro.models import quantize as jq  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels.quant_matmul import (  # noqa: E402
    quant_matmul_int4, quant_matmul_int4_plain, quant_matmul_int8,
    quant_matmul_int8_plain)
from repro_torch.models import quantize as tq  # noqa: E402
from repro_torch.models.transformer import _layer  # noqa: E402

MM_TOL = 1e-4
# tests/test_quant_matmul.py's SHAPES (K = 96: int4 group gcd(96, 64) =
# 32) and two of smollm-360m's projection sites at decode
SHAPES = [(4, 64, 32), (3, 128, 96), (2, 96, 48), (1, 256, 300),
          (8, 960, 320), (8, 2560, 960)]


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _pack_both(w: np.ndarray, fmt: str):
    jp = (jq.quantize_int8 if fmt == "int8" else jq.quantize_int4)(
        jnp.asarray(w))
    tp = (tq.quantize_int8 if fmt == "int8" else tq.quantize_int4)(t(w))
    return {k: np.asarray(v) for k, v in jp.items()}, tp


@pytest.mark.parametrize("shape", [(64, 32), (96, 48), (960, 320),
                                   (2, 128, 96), (66, 5)])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantize_matches_jax(shape, fmt):
    rng = np.random.default_rng(1)
    w = rng.standard_normal(shape, dtype=np.float32) * 0.05
    jp, tp = _pack_both(w, fmt)
    assert tp["q"].dtype == (torch.int8 if fmt == "int8" else torch.uint8)
    assert tp["s"].dtype == torch.float32
    np.testing.assert_array_equal(tp["q"].numpy(), jp["q"])
    # scales: within one f32 ulp of the reference's
    ulp = np.spacing(np.abs(jp["s"]))
    assert np.all(np.abs(tp["s"].numpy() - jp["s"]) <= ulp)
    np.testing.assert_array_equal(tq.dequantize(tp).numpy(),
                                  np.asarray(jq.dequantize(
                                      {k: jnp.asarray(v)
                                       for k, v in jp.items()})))


def test_pack_unpack_int4_match_jax():
    rng = np.random.default_rng(2)
    q = rng.integers(-8, 8, (3, 10, 7)).astype(np.int8)
    # reprolint: disable-next=quant-static-weights -- unit test of
    # the port's packers
    packed = tq.pack_int4(t(q))
    # reprolint: disable-next=quant-static-weights -- unit test of
    # the port's packers
    want = np.asarray(jq.pack_int4(jnp.asarray(q)))
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), q)
    np.testing.assert_array_equal(
        tq.unpack_int4(packed).numpy(),
        np.asarray(jq.unpack_int4(jnp.asarray(packed.numpy()))))


def test_format_tables_match_jax():
    assert tq.QUANT_KEYS == jq.QUANT_KEYS and tq.QFORMATS == jq.QFORMATS
    assert tq.BYTES_PER_PARAM == jq.BYTES_PER_PARAM
    for fmt in ("int8", "int4"):
        for arch in ("smollm-360m", "mixtral-8x7b-smoke"):
            assert (tq.golden_token_match_floor(arch, fmt)
                    == jq.golden_token_match_floor(arch, fmt))
    assert tq.normalize_format("bf16") is None
    with pytest.raises(ValueError):
        tq.quantize_params({}, "int3")


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantize_params_on_bridged_tree(fmt):
    """The same keys are packed as in the JAX tree; norms, embeddings
    and odd-K int4 weights stay dense; packing is idempotent and a
    no-op for None / "bf16"."""
    jc, tc = config_pair("gqa")
    npp = jax_params(jc, seed=3)
    tp = bridged(npp, tc)
    assert tq.quantize_params(tp, None) is tp
    assert tq.quantize_params(tp, "bf16") is tp
    packed = tq.quantize_params(tp, fmt)
    jpacked = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, npp),
                                 fmt)
    seg, jseg = packed["blocks"]["segments"][0], \
        jpacked["blocks"]["segments"][0]
    for group in ("attn", "mlp"):
        for key, w in seg[group].items():
            assert tq.is_quantized(w) == jq.is_quantized(jseg[group][key])
            assert tq.is_quantized(w) == (key in tq.QUANT_KEYS)
            # stacked (n_layers, K, N): every layer packs as JAX packs it
            np.testing.assert_array_equal(w["q"].numpy(),
                                          np.asarray(jseg[group][key]["q"]))
    for dense in (packed["embed"]["w"], packed["final_norm"]["scale"],
                  seg["ln1"]["scale"], seg["ln2"]["scale"]):
        assert isinstance(dense, torch.Tensor)
    # the round trip back to dense weights, as the reference expands it
    back = tq.dequantize_params(packed, torch.float32)
    jback = jq.dequantize_params(jpacked, jnp.float32)
    np.testing.assert_array_equal(
        back["blocks"]["segments"][0]["mlp"]["w_down"].numpy(),
        np.asarray(jback["blocks"]["segments"][0]["mlp"]["w_down"]))
    assert torch.equal(back["embed"]["w"], packed["embed"]["w"])
    again = tq.quantize_params(packed, fmt)
    assert again["blocks"]["segments"][0]["attn"]["wq"]["q"] is \
        seg["attn"]["wq"]["q"]
    # an odd-K projection stays dense under int4 (nibbles pack in pairs)
    odd = {"w_down": torch.ones((2, 5, 4))}
    out = tq.quantize_params(odd, fmt)
    assert tq.is_quantized(out["w_down"]) == (fmt == "int8")


def test_packed_leaves_slice_per_layer():
    """``transformer._layer`` recurses into dicts, so layer j of a
    packed stacked leaf is exactly layer j packed on its own."""
    rng = np.random.default_rng(4)
    w = t(rng.standard_normal((3, 128, 40), dtype=np.float32))
    for fmt in ("int8", "int4"):
        stacked = tq.quantize_params({"wq": w}, fmt)
        for j in range(3):
            alone = tq.quantize_params({"wq": w[j]}, fmt)["wq"]
            got = _layer(stacked, j)["wq"]
            assert torch.equal(got["q"], alone["q"])
            assert torch.equal(got["s"], alone["s"])


def test_bridge_keeps_packed_leaves():
    """A tree the reference packed bridges with int8 / uint8 ``q`` and
    f32 ``s``, whatever the model dtype; a one-layer segment gains its
    layer dim on both."""
    jc, tc = config_pair("mha")
    one_j = dataclasses.replace(jc, n_layers=1, block_pattern=("attn",))
    one_t = dataclasses.replace(tc, n_layers=1, block_pattern=("attn",))
    for fmt, qdtype in (("int8", torch.int8), ("int4", torch.uint8)):
        npp = jax_params(one_j, seed=5)
        jpacked = jax.tree_util.tree_map(
            np.asarray, jq.quantize_params(
                jax.tree_util.tree_map(jnp.asarray, npp), fmt))
        tp = params_from_numpy(jpacked, one_t, "cpu", torch.bfloat16)
        wq = tp["blocks"]["segments"][0]["attn"]["wq"]
        assert wq["q"].dtype == qdtype and wq["s"].dtype == torch.float32
        assert torch.equal(wq["q"][0],
                           t(jpacked["blocks"]["segments"][0]["attn"]["wq"]["q"]))
        assert tp["embed"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_plain_quant_matmul_matches_jax(m, k, n, fmt):
    rng = np.random.default_rng(6)
    w = rng.standard_normal((k, n), dtype=np.float32) * k ** -0.5
    x = rng.standard_normal((m, k), dtype=np.float32)
    jp, tp = _pack_both(w, fmt)
    plain = (quant_matmul_int8_plain if fmt == "int8"
             else quant_matmul_int4_plain)
    got = plain(t(x), tp["q"], tp["s"]).numpy()
    args = (jnp.asarray(x), jnp.asarray(jp["q"]), jnp.asarray(jp["s"]))
    oracle = (ref.quant_matmul_int8_ref if fmt == "int8"
              else ref.quant_matmul_int4_ref)(*args)
    assert _err(got, oracle) < MM_TOL
    assert _err(got, quant_matmul_pallas(*args, interpret=True)) < MM_TOL
    assert _err(got, jq.qdot(args[0], {"q": args[1], "s": args[2]})) < MM_TOL
    # the wrapper and qdot take the plain version for CPU tensors
    wrapper = quant_matmul_int8 if fmt == "int8" else quant_matmul_int4
    assert torch.equal(wrapper(t(x), tp["q"], tp["s"]), t(got))
    assert torch.equal(tq.qdot(t(x), tp), t(got))


def test_plain_quant_matmul_keeps_leading_dims_and_dtype():
    rng = np.random.default_rng(7)
    w = t(rng.standard_normal((64, 24), dtype=np.float32) * 0.125)
    x = t(rng.standard_normal((2, 3, 64), dtype=np.float32)).to(
        torch.bfloat16)
    for fmt in ("int8", "int4"):
        packed = tq.quantize_params({"wo": w}, fmt)["wo"]
        out = tq.qdot(x, packed)
        assert out.shape == (2, 3, 24) and out.dtype == torch.bfloat16
        flat = tq.qdot(x.reshape(6, 64), packed)
        assert torch.equal(out.reshape(6, 24), flat)


def test_qdot_plain_tensor_is_matmul():
    rng = np.random.default_rng(8)
    x = t(rng.standard_normal((5, 1, 32), dtype=np.float32))
    w = t(rng.standard_normal((32, 16), dtype=np.float32))
    assert torch.equal(tq.qdot(x, w), x @ w)
