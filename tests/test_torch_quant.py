"""The port's planar decomposition, QTensor and plain quant_matmul against
the JAX package: to_planar and dequantize are bit-exact for Q4_K, Q6_K and
Q8_0; the plain matmul matches quant_matmul(backend="xla") to f32 rounding
and, on one tiny case, the Pallas kernels run in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.gguf import planar as jax_planar
from mistralrs_tpu.gguf.constants import GGMLType as JaxType
from mistralrs_tpu.gguf.quants import quantize
from mistralrs_tpu.ops.quant_matmul import quant_matmul as jax_qmm
from mistralrs_tpu.quant.qtensor import QTensor as JaxQTensor
from mistralrs_tpu_torch.gguf import planar
from mistralrs_tpu_torch.gguf.constants import GGMLType
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.quant_matmul import quant_matmul
from mistralrs_tpu_torch.quant.linear import embedding_lookup
from mistralrs_tpu_torch.quant.qtensor import QTensor

TYPES = ["Q4_K", "Q6_K", "Q8_0"]


def _raw(name, n=96, k=512, seed=0):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return w, quantize(w, JaxType[name])


@pytest.mark.parametrize("name", TYPES)
def test_planar_and_dequant_bit_exact(name):
    w, raw = _raw(name)
    a = jax_planar.to_planar(raw, JaxType[name])
    b = planar.to_planar(raw, GGMLType[name])
    for field in ("q", "scale"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert (a.bias is None) == (b.bias is None)
    if a.bias is not None:
        np.testing.assert_array_equal(a.bias, b.bias)
    assert (a.group_size, a.code_bits, a.signed) == (b.group_size, b.code_bits, b.signed)
    jq = JaxQTensor.from_gguf_raw(raw, JaxType[name], w.shape)
    tq = QTensor.from_gguf_raw(raw, GGMLType[name], w.shape, device="cpu")
    assert (tq.packed, tq.group_size, tq.shape) == (jq.packed, jq.group_size, jq.shape)
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_array_equal(tq.dequantize().numpy(), np.asarray(jq.dequantize()))


@pytest.mark.parametrize("name", TYPES)
@pytest.mark.parametrize("m", [1, 5])
def test_plain_matmul_matches_xla_f32(name, m):
    """f32 dequant and f32 inputs: only the order of f32 sums differs
    (rtol 1e-5 of the largest output)."""
    w, raw = _raw(name, seed=1)
    jq = JaxQTensor.from_gguf_raw(raw, JaxType[name], w.shape)
    tq = QTensor.from_gguf_raw(raw, GGMLType[name], w.shape, device="cpu")
    x = np.random.default_rng(2).standard_normal((m, 512)).astype(np.float32)
    ref = np.asarray(jax_qmm(jnp.asarray(x), jq, backend="xla", dequant_dtype=jnp.float32))
    reset_counts()
    got = quant_matmul(torch.from_numpy(x), tq, compute_dtype=torch.float32).numpy()
    kernel = "w4_matmul" if tq.packed else "w8_matmul"
    assert COUNTS[kernel + "_plain"] == 1 and COUNTS[kernel] == 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", TYPES)
def test_plain_matmul_matches_xla_bf16(name):
    """bf16 dequant and inputs, f32 accumulation, bf16 output: identical
    arithmetic to the XLA path up to sum order (atol 1e-2 of the max)."""
    w, raw = _raw(name, seed=3)
    jq = JaxQTensor.from_gguf_raw(raw, JaxType[name], w.shape)
    tq = QTensor.from_gguf_raw(raw, GGMLType[name], w.shape, device="cpu")
    x = np.random.default_rng(4).standard_normal((3, 7, 512)).astype(np.float32)
    ref = np.asarray(jax_qmm(jnp.asarray(x, jnp.bfloat16), jq, backend="xla"), np.float32)
    got = quant_matmul(torch.from_numpy(x).to(torch.bfloat16), tq)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 7, 96)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["Q4_K", "Q8_0"])
def test_plain_matmul_matches_pallas_interpret(name):
    """The JAX W4/W8 Pallas kernels (interpret mode) on a tiny case. The W4
    kernel adds the k-quant bias in f32 outside the bf16 weight while the
    port folds it into the weight, so outputs agree to bf16 rounding
    (atol 1e-2 of the max)."""
    w, raw = _raw(name, n=128, k=256, seed=5)
    jq = JaxQTensor.from_gguf_raw(raw, JaxType[name], w.shape)
    tq = QTensor.from_gguf_raw(raw, GGMLType[name], w.shape, device="cpu")
    x = np.random.default_rng(6).standard_normal((4, 256)).astype(np.float32)
    ref = np.asarray(jax_qmm(jnp.asarray(x, jnp.bfloat16), jq, backend="pallas",
                             interpret=True), np.float32)
    got = quant_matmul(torch.from_numpy(x).to(torch.bfloat16), tq).float().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("name", TYPES)
def test_embedding_lookup_rows_exact(name):
    """Planar row gather equals the dequantized table's rows bit for bit."""
    w, raw = _raw(name, n=64, k=256, seed=8)
    tq = QTensor.from_gguf_raw(raw, GGMLType[name], w.shape, device="cpu")
    ids = torch.tensor([[3, 0, 63], [7, 7, 1]])
    rows = embedding_lookup(ids, tq, dtype=torch.float32)
    np.testing.assert_array_equal(rows.numpy(), tq.dequantize()[ids].numpy())


def test_unported_type_raises():
    """Q8_1 (an activation format, no weight type of a file) has no planar
    decomposition in either package."""
    with pytest.raises(NotImplementedError):
        planar.to_planar(np.zeros(36, np.uint8), GGMLType.Q8_1)
