"""The port's GGUF planar types against the JAX package on the CPU: all ten
decompositions (Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K,
Q6_K) and ``dequantize`` bit-equal to JAX ``to_planar`` /
``gguf/quants.py::dequantize``, the port's planes equal to JAX
``QTensor.from_gguf_raw``'s (Q2_K's 2-bit codes packed in nibbles at group
16), and the plain matmuls at W4 group 16 against JAX's XLA path and its
Pallas kernels in interpret mode.

Blocks come from JAX ``gguf/quants.py::quantize`` where it has a quantizer
for the type, and are drawn as random bytes with f16 fields in a sane range
for every type, including blocks whose sub-scales are all at their extremes
(all bits set, none set, int8 -128). Tolerances: the plain matmuls against
the XLA path in f32 differ only in f32 sum order (1e-5 of the largest
|output|); against the Pallas kernels (bf16 inputs, the bias outside the
rounded weight there) 1e-2 of the largest."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.gguf import planar as jax_planar
from mistralrs_tpu.gguf.constants import GGMLType as JaxType
from mistralrs_tpu.gguf.constants import type_traits
from mistralrs_tpu.gguf.quants import QUANTIZERS
from mistralrs_tpu.gguf.quants import dequantize as jax_dequantize
from mistralrs_tpu.gguf.quants import quantize
from mistralrs_tpu.ops.moe_grouped import build_groups as jax_build_groups
from mistralrs_tpu.ops.quant_matmul import quant_matmul as jax_qmm
from mistralrs_tpu.ops.quant_matmul import quant_matmul_grouped as jax_qmm_g
from mistralrs_tpu.quant.qtensor import QTensor as JaxQTensor
from mistralrs_tpu_torch.gguf import planar
from mistralrs_tpu_torch.gguf.constants import GGMLType
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.moe_grouped import build_groups
from mistralrs_tpu_torch.ops.quant_matmul import (
    _check_planes,
    quant_matmul,
    quant_matmul_grouped,
)
from mistralrs_tpu_torch.quant.qtensor import QTensor

TYPES = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K"]
# byte offsets of each block's f16 fields, and of its sub-scales (K types)
F16_FIELDS = {"Q4_0": (0,), "Q4_1": (0, 2), "Q5_0": (0,), "Q5_1": (0, 2), "Q8_0": (0,),
              "Q2_K": (80, 82), "Q3_K": (108,), "Q4_K": (0, 2), "Q5_K": (0, 2), "Q6_K": (208,)}
SUB_SCALES = {"Q2_K": (0, 16), "Q3_K": (96, 108), "Q4_K": (4, 16), "Q5_K": (4, 16),
              "Q6_K": (192, 208)}


def random_blocks(name: str, n_blocks: int, rng) -> np.ndarray:
    """``n_blocks`` blocks of random bytes, their f16 fields N(0, 0.01^2)
    (finite, some subnormal-small), the sub-scales of blocks 0-3 all ones,
    4-7 all zeros and 8-11 all 0x80 (int8 -128 for Q6_K)."""
    size = type_traits(JaxType[name]).type_size
    raw = rng.integers(0, 256, (n_blocks, size), dtype=np.uint8)
    for off in F16_FIELDS[name]:
        raw[:, off:off + 2] = (rng.standard_normal(n_blocks) * 1e-2).astype(
            np.float16).view(np.uint8).reshape(n_blocks, 2)
    if name in SUB_SCALES:
        a, b = SUB_SCALES[name]
        for i, byte in enumerate((0xFF, 0x00, 0x80)):
            raw[4 * i:4 * i + 4, a:b] = byte
    return raw.reshape(-1)


def _blocks(name, source, n=64, k=512, seed=0):
    """Raw bytes of an ``[n, k]`` tensor: JAX ``quantize`` of N(0, 1)
    weights, or :func:`random_blocks`."""
    rng = np.random.default_rng(seed)
    if source == "quantize":
        return quantize(rng.standard_normal((n, k)).astype(np.float32), JaxType[name])
    return random_blocks(name, n * k // type_traits(JaxType[name]).block_size, rng)


CASES = [(t, "quantize") for t in TYPES if JaxType[t] in QUANTIZERS] + [
    (t, "random") for t in TYPES]


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name,source", CASES)
def test_planar_and_dequantize_bit_equal(name, source):
    """Codes, scales, biases, group size, code bits and signedness equal JAX
    ``to_planar``'s bit for bit; ``dequantize`` equals JAX
    ``quants.dequantize`` value for value (bit for bit but the sign of a
    zero: JAX computes Q4_0 and Q5_0 as ``d (q - 8)``, -0 for a negative
    ``d`` at ``q = 8``, where the planar ``d q - 8 d`` gives +0, as JAX's
    own planar form does); the QTensor's planes equal JAX
    ``QTensor.from_gguf_raw``'s (packing included)."""
    n, k = 64, 512
    raw = _blocks(name, source, n, k)
    a = jax_planar.to_planar(raw, JaxType[name])
    b = planar.to_planar(raw, GGMLType[name])
    assert (a.group_size, a.code_bits, a.signed) == (b.group_size, b.code_bits, b.signed)
    assert b.q.dtype == (torch.int8 if a.signed else torch.uint8)
    for field in ("q", "scale"):
        np.testing.assert_array_equal(_bits(getattr(b, field)), _bits(getattr(a, field)))
    assert (a.bias is None) == (b.bias is None)
    if a.bias is not None:
        np.testing.assert_array_equal(_bits(b.bias), _bits(a.bias))
    want = jax_dequantize(raw, JaxType[name], (n, k))
    got = planar.dequantize(raw, GGMLType[name], (n, k))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)  # -0.0 == 0.0
    nonzero = want != 0
    np.testing.assert_array_equal(_bits(got)[nonzero], _bits(want)[nonzero])
    np.testing.assert_array_equal(_bits(got), _bits(a.dequantize().reshape(n, k)))
    jq = JaxQTensor.from_gguf_raw(raw, JaxType[name], (n, k))
    tq = QTensor.from_gguf_raw(raw, GGMLType[name], (n, k), device="cpu")
    assert (tq.packed, tq.group_size, tq.shape) == (jq.packed, jq.group_size, jq.shape)
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_array_equal(_bits(tq.scale), _bits(jq.scale))
    if jq.bias is not None:
        np.testing.assert_array_equal(_bits(tq.bias), _bits(jq.bias))
    np.testing.assert_array_equal(_bits(tq.dequantize()), _bits(jq.dequantize()))


def test_q2k_packs_at_group_16():
    """Q2_K's 2-bit codes pack into nibbles (byte j: code j and code j +
    K/2) at group 16, as JAX ``QTensor.from_planar`` packs them; Q3_K's
    signed codes keep a byte a code; a bank stacks and splits back."""
    raw = _blocks("Q2_K", "quantize", 32, 512, seed=1)
    tq = QTensor.from_gguf_raw(raw, GGMLType.Q2_K, (32, 512), device="cpu")
    assert tq.packed and tq.group_size == 16 and tq.code_bits == 2
    assert tq.data.shape == (256, 32) and tq.scale.shape == tq.bias.shape == (32, 32)
    codes = planar.to_planar(raw, GGMLType.Q2_K).q.reshape(32, 512).T
    np.testing.assert_array_equal(tq.data.numpy(), (codes[:256] | (codes[256:] << 4)).numpy())
    q3 = QTensor.from_gguf_raw(_blocks("Q3_K", "quantize", 32, 512), GGMLType.Q3_K,
                               (32, 512), device="cpu")
    assert not q3.packed and q3.signed and q3.group_size == 16 and q3.bias is None
    bank = QTensor.stack([tq, tq])
    assert bank.num_banks == 2 and bank.group_size == 16 and bank.packed
    np.testing.assert_array_equal(bank.bank(1).dequantize().numpy(), tq.dequantize().numpy())


def test_load_decodes_on_the_bytes_device():
    """``to_planar`` of a uint8 tensor runs on that tensor (a tensor's raw
    blocks decode where they are) and gives the numpy path's planes."""
    raw = _blocks("Q5_K", "random", 16, 512, seed=2)
    a = planar.to_planar(raw, GGMLType.Q5_K)
    b = planar.to_planar(torch.from_numpy(raw.copy()), GGMLType.Q5_K)
    for f in ("q", "scale", "bias"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    with pytest.raises(TypeError, match="uint8"):
        planar.to_planar(torch.zeros(176, dtype=torch.int8), GGMLType.Q5_K)


def _q2k_pair(n, k, seed, e=None):
    """A Q2_K matrix (or bank of ``e``) in both packages."""
    rng = np.random.default_rng(seed)
    shape = (n, k) if e is None else (e, n, k)
    raw = quantize((rng.standard_normal(shape) * 0.05).astype(np.float32), JaxType.Q2_K)
    if e is None:
        return (JaxQTensor.from_gguf_raw(raw, JaxType.Q2_K, shape),
                QTensor.from_gguf_raw(raw, GGMLType.Q2_K, shape, device="cpu"))
    import jax

    per = raw.reshape(e, -1)
    jq = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[
        JaxQTensor.from_gguf_raw(per[i], JaxType.Q2_K, (n, k)) for i in range(e)])
    return jq, QTensor.from_gguf_raw(raw, GGMLType.Q2_K, shape, device="cpu")


@pytest.mark.parametrize("m", [1, 5, 40])
def test_w4_g16_plain_matches_xla(m):
    """The plain W4 version at group 16 (Q2_K) against JAX
    ``quant_matmul(backend="xla")`` in f32: 1e-5 of the largest |output|;
    it counts as ``w4_matmul_g16_plain``."""
    jq, tq = _q2k_pair(96, 512, seed=3)
    assert jq.packed and jq.group_size == 16
    x = np.random.default_rng(4).standard_normal((m, 512)).astype(np.float32)
    ref = np.asarray(jax_qmm(jnp.asarray(x), jq, backend="xla", dequant_dtype=jnp.float32))
    reset_counts()
    got = quant_matmul(torch.from_numpy(x), tq, compute_dtype=torch.float32).numpy()
    assert COUNTS == {"w4_matmul_g16_plain": 1}
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _routed(n_tok, top, e, tm, h, seed):
    rng = np.random.default_rng(seed)
    topi = np.stack([rng.permutation(e)[:top] for _ in range(n_tok)]).astype(np.int32)
    topw = rng.uniform(0.1, 1, (n_tok, top)).astype(np.float32)
    x = rng.standard_normal((n_tok, h)).astype(np.float32)
    st, dest, _, tiles, mp = jax_build_groups(jnp.asarray(topi), jnp.asarray(topw), e, tm)
    xs = jnp.zeros((mp, h), jnp.float32).at[dest].set(jnp.asarray(x)[st])
    t_st, t_dest, _, t_tiles, n_used, _ = build_groups(torch.from_numpy(topi),
                                                        torch.from_numpy(topw), e, tm)
    txs = torch.zeros((xs.shape[0], h))
    txs[t_dest] = torch.from_numpy(x)[t_st]
    return (xs, tiles), (txs, t_tiles, n_used)


@pytest.mark.parametrize("tm", [16, 64])
def test_w4_g16_grouped_plain_matches_xla(tm):
    """The plain grouped W4 version over a Q2_K bank against JAX
    ``quant_matmul_grouped(backend="xla")`` in f32 (1e-5 of the largest):
    the plain versions are generic in the group size."""
    e, n, k = 6, 64, 256
    jq, tq = _q2k_pair(n, k, seed=5, e=e)
    (xs, tiles), (txs, t_tiles, n_used) = _routed(24, 2, e, tm, k, seed=6)
    ref = np.asarray(jax_qmm_g(xs, jq, tiles, tm=tm, backend="xla",
                               dequant_dtype=jnp.float32, out_dtype=jnp.float32))
    reset_counts()
    got = quant_matmul_grouped(txs, tq, t_tiles, tm=tm, n_used_tiles=n_used,
                               compute_dtype=torch.float32).numpy()
    assert COUNTS == {"w4_matmul_g16_g_plain": 1}
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_w4_g16_plain_matches_pallas_interpret():
    """One small case each of the JAX ``_w4_matmul`` and ``_w4_matmul_g``
    Pallas kernels at group 16, in interpret mode, against the plain
    versions in bf16 (1e-2 of the largest |output|)."""
    jq, tq = _q2k_pair(128, 256, seed=7)
    x = np.random.default_rng(8).standard_normal((4, 256)).astype(np.float32)
    ref = np.asarray(jax_qmm(jnp.asarray(x, jnp.bfloat16), jq, backend="pallas",
                             interpret=True), np.float32)
    got = quant_matmul(torch.from_numpy(x).to(torch.bfloat16), tq).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    e = 4
    jb, tb = _q2k_pair(128, 256, seed=9, e=e)
    (xs, tiles), (txs, t_tiles, n_used) = _routed(6, 2, e, 16, 256, seed=10)
    ref = np.asarray(jax_qmm_g(xs.astype(jnp.bfloat16), jb, tiles, tm=16, backend="pallas",
                               interpret=True, out_dtype=jnp.float32))
    got = quant_matmul_grouped(txs.to(torch.bfloat16), tb, t_tiles, tm=16, n_used_tiles=n_used,
                               out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())


def test_w4_g16_refused_where_halves_split_groups():
    """The W4 kernels take group 16 where (K/2) % 16 == 0, for one matrix
    and a bank alike; a packed plane whose halves would split a group is
    refused by name before any launch."""
    ok = QTensor(torch.zeros((128, 32), dtype=torch.uint8), torch.ones((16, 32)),
                 torch.zeros((16, 32)), group_size=16, packed=True, code_bits=2)
    assert _check_planes(ok) == 0
    bank = QTensor.stack([ok, ok])
    assert _check_planes(bank) == 0
    bad = QTensor(torch.zeros((24, 32), dtype=torch.uint8), torch.ones((3, 32)),
                  torch.zeros((3, 32)), group_size=16, packed=True, code_bits=2)
    with pytest.raises(ValueError, match=r"group size 16, 32, 64 or 128 dividing K/2 = 24"):
        _check_planes(bad)
    with pytest.raises(ValueError, match=r"dividing K/2 = 24"):
        _check_planes(QTensor.stack([bad, bad]))
