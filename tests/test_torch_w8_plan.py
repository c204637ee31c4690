"""The W8 kernel's plan and arithmetic on the CPU.

``w8_plan`` picks the W8 kernel's body: the decode body shared with W4
(``csrc/mm_decode.cuh``) for at most 16 rows, split by the same rule
(``decode_splits``), and the wmma body above. These tests pin what the
card's kernel relies on: the Llama-3-8B and Mixtral-8x7B W8 shapes fill the
card with >= 2 blocks per SM, the splits cover K in whole steps, and the
byte -> bf16 conversion is exact. The decode body splits each byte into
nibbles that are exact bf16 values (128 + lo by OR with 0x4300, 2048 + 16 hi
by OR with 0x4500), sums x * (2176 + u) per group on the tensor cores, with
u = q + 128 (XOR 0x80) for signed codes, and applies scale and bias to the
f32 group sums. A plain model of that arithmetic is held against
``quant_matmul_plain`` (which rounds the weight to bf16: 1e-2 of the largest
output, the kernels' stated tolerance) and against JAX ``_deq_dot``'s
``f32dot_bias`` branch (the same sums in another f32 order: 1e-5 of the
largest output).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu_torch.ops.quant_matmul import (
    DECODE_COLUMNS,
    DECODE_STEP,
    W8_DECODE_COLUMNS,
    quant_matmul_plain,
    split_steps,
    w8_plan,
)
from mistralrs_tpu_torch.quant.qtensor import QTensor

jax_qm = importlib.import_module("mistralrs_tpu.ops.quant_matmul")

# (N, K): Llama-3-8B's Q8_0 head, Mixtral-8x7B's Q8_0 attn_v and Q6_K head,
# and a Q6_K-style down projection
W8_DECODE = [(128256, 4096), (1024, 4096), (32000, 4096), (4096, 14336)]


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("n,k", W8_DECODE)
def test_w8_decode_shapes_fill_the_card(n, k, m):
    plan = w8_plan(m, n, k, 132)
    assert plan.body == "decode" and plan.tile == (8 if m <= 8 else 16)
    assert -(-n // plan.columns) * plan.splits >= 264


def test_block_width():
    """128-column blocks (128-byte code rows) where they can fill the card;
    Mixtral's attn_v (8 such tiles, 32 steps) takes 64-column blocks."""
    head, attn_v = w8_plan(8, 128256, 4096, 132), w8_plan(8, 1024, 4096, 132)
    assert (head.columns, head.splits) == (W8_DECODE_COLUMNS, 1)
    assert attn_v.columns == DECODE_COLUMNS and attn_v.splits >= 17
    assert w8_plan(8, 4096, 14336, 132).columns == W8_DECODE_COLUMNS


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("n,k", W8_DECODE + [(336, 128), (1024, 512)])
def test_splits_cover_k_in_whole_steps(n, k, sms):
    plan = w8_plan(8, n, k, sms)
    steps = split_steps(k, plan.splits)
    assert steps[0][0] == 0 and steps[-1][1] == k // DECODE_STEP
    assert all(b == c for (_, b), (c, _) in zip(steps, steps[1:]))
    assert all(b > a for a, b in steps)
    assert 1 <= plan.splits <= k // DECODE_STEP


@pytest.mark.parametrize("m", [17, 64, 512])
def test_more_rows_take_the_wmma_body(m):
    plan = w8_plan(m, 1024, 4096, 132)
    assert (plan.body, plan.tile, plan.splits) == ("prefill", 64, 1)


def _bf16_pair(word: torch.Tensor, orr: int) -> torch.Tensor:
    """The kernel's nib_pair / nib_pair_x16: (word & 0x000F000F) | orr as
    two bf16 values (low half first), in f64."""
    v = (word & 0x000F000F) | orr
    halves = torch.stack([v & 0xFFFF, (v >> 16) & 0xFFFF], -1).to(torch.int16)
    return halves.view(torch.bfloat16).to(torch.float64)


@pytest.mark.parametrize("signed", [False, True])
def test_byte_to_bf16_is_exact_for_every_byte(signed):
    """Every byte value in every byte of a code word: the lo pair plus the
    hi pair is 2176 + u exactly, u = the byte (unsigned) or q + 128 for the
    signed code q (the byte XOR 0x80); bytes 0 and 2 land in the pair of
    word, bytes 1 and 3 in the pair of word >> 8 (ldmatrix.trans's layout)."""
    q = torch.arange(-128, 128) if signed else torch.arange(256)
    byte = q & 0xFF
    u = q + 128 if signed else q
    for pos in range(4):
        word = (byte << (8 * pos)) | (0x5A << (8 * ((pos + 1) % 4)))  # a neighbour byte
        if signed:
            word = word ^ 0x80808080
        shift, half = (0, pos // 2) if pos % 2 == 0 else (8, pos // 2)
        lo = _bf16_pair(word >> shift, 0x43004300)[:, half]
        hi = _bf16_pair(word >> (shift + 4), 0x45004500)[:, half]
        assert torch.equal(lo + hi, 2176.0 + u.to(torch.float64))
        assert torch.equal(lo, 128.0 + (u & 15)) and torch.equal(hi, 2048.0 + 16 * (u >> 4))


def _q8(n, k, gs, signed, bias, seed):
    rng = np.random.default_rng(seed)
    lo = -128 if signed else 0
    data = rng.integers(lo, lo + 256, (k, n)).astype(np.int8 if signed else np.uint8)
    scale = (0.5 + rng.random((k // gs, n))).astype(np.float32) / 64
    b = ((-0.5 + rng.random(scale.shape)).astype(np.float32) * 64 * scale) if bias else None
    return QTensor(torch.from_numpy(data), torch.from_numpy(scale),
                   None if b is None else torch.from_numpy(b), group_size=gs, packed=False,
                   code_bits=8)


def _decode_body_model(x2, qt, signed):
    """The W8 decode body's arithmetic: per group, x (bf16) times the exact
    2176 + u summed exactly, rounded to f32 (the tensor cores' f32 sum), and
    the group sum of x; then acc += scale * sum + (bias - OFF scale) * sum(x)
    in f32, OFF = 2304 for signed codes (u = q + 128), 2176 for unsigned."""
    m, k = x2.shape
    n, gs = qt.out_features, qt.group_size
    q = qt.data.to(torch.float64)  # [K, N]
    u = q + 128.0 if signed else q
    xb = x2.to(torch.bfloat16).to(torch.float64)
    g = k // gs
    tq = torch.einsum("mgi,gin->mgn", xb.reshape(m, g, gs),
                      (2176.0 + u).reshape(g, gs, n)).to(torch.float32)
    t1 = xb.reshape(m, g, gs).sum(-1).to(torch.float32)  # [M, G]
    s = qt.scale
    off = 2304.0 if signed else 2176.0
    c = (qt.bias if qt.bias is not None else torch.zeros_like(s)) - off * s
    return (tq * s[None] + t1[:, :, None] * c[None]).sum(1)


@pytest.mark.parametrize("gs", [16, 32])
@pytest.mark.parametrize("fmt", ["s8", "s8_bias", "u8_bias"])
@pytest.mark.parametrize("m", [1, 8, 16])
def test_decode_arithmetic_matches_plain_and_jax(m, fmt, gs):
    signed, bias = fmt.startswith("s8"), fmt.endswith("bias")
    qt = _q8(96, 512, gs, signed, bias, seed=m + gs)
    x = torch.from_numpy(np.random.default_rng(100 + m).standard_normal((m, 512))
                         .astype(np.float32)).to(torch.bfloat16)
    got = _decode_body_model(x, qt, signed)
    plain = quant_matmul_plain(x, qt, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(),
                               atol=1e-2 * plain.abs().max().item())
    # JAX's f32dot_bias: dot(x, q * s) + dot(group sums of x, b), in f32
    q = qt.data.numpy().astype(np.int32)
    b = (qt.bias if bias else torch.zeros_like(qt.scale)).numpy()
    ref = np.asarray(jax_qm._deq_dot(jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(q),
                                     jnp.asarray(qt.scale.numpy()), jnp.asarray(b), gs,
                                     jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max())
