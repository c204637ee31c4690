"""The W8 kernel's plans and arithmetic on the CPU.

``w8_plan`` picks the W8 kernel's body (``csrc/w8_matmul.cu``): the decode
body shared with W4 (``csrc/mm_decode.cuh``) for row tiles of at most 16
rows (one matrix of M <= 16, split by the same rule, ``decode_splits``; a
bank's 16-row tiles, one split each), and the wgmma prefill body for more
rows (one matrix in 64- or 128-row tiles, K split by ``prefill_splits``; a
bank's 64-row tiles). These tests pin what the card's kernel relies on: the
Llama-3-8B and Mixtral-8x7B W8 shapes fill the card (the decode body with
>= 2 blocks per SM, the prefill body with >= 1), the splits cover K in whole
steps, and the byte conversions are exact.

The decode body splits each byte into nibbles that are exact bf16 values
(128 + lo by OR with 0x4300, 2048 + 16 hi by OR with 0x4500), sums x * (2176
+ u) per group on the tensor cores, with u = q + 128 (XOR 0x80) for signed
codes, and applies scale and bias to the f32 group sums. A plain model of
that arithmetic, for one matrix and tile by tile for a bank, is held against
the plain versions (which round the weight to bf16: 1e-2 of the largest
output, the kernels' stated tolerance), the JAX package's grouped matmul
(the same) and JAX ``_deq_dot``'s ``f32dot_bias`` branch (the same sums in
another f32 order: 1e-5 of the largest output). The prefill body makes the
weight itself: the byte placed in the mantissa of 2^23 by one prmt (signed
codes XORed with 0x80 first), less 2^23 (or 2^23 + 128), then scale * q and
+ bias in f32, rounded to bf16 in pairs; a model of those bit operations
equals the plain version's bf16 weight for every byte value. The e4m3 form
(FP8 weights) converts each byte through the hardware fp8 -> f16
instruction, exact for every e4m3 value (the two NaNs aside): the decode
body's bf16 pairs are the values themselves, the prefill body's weights the
plain version's ``bf16(scale * q)``; its plan is the W8 plan at its group
size.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.quant.qtensor import QTensor as JaxQTensor
from mistralrs_tpu_torch.ops.moe_grouped import build_groups
from mistralrs_tpu_torch.ops.quant_matmul import (
    DECODE_COLUMNS,
    DECODE_STEP,
    PREFILL_COLUMNS,
    PREFILL_STEP,
    W8_DECODE_COLUMNS,
    W8_GROUPED_PREFILL_TILE,
    prefill_cost,
    quant_matmul_grouped_plain,
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


@pytest.mark.parametrize("m", [17, 64, 130, 512])
def test_more_rows_take_the_prefill_body(m):
    """More than 16 rows take the wgmma prefill body in 256-column blocks,
    64-row tiles where 128-row ones cannot give every SM a block."""
    plan = w8_plan(m, 1024, 4096, 132)
    assert (plan.body, plan.tile, plan.columns) == ("prefill", 64, PREFILL_COLUMNS)
    big = w8_plan(4096, 14336, 4096, 132)  # 32 x 56 tiles of 128 rows
    assert (big.body, big.tile, big.splits) == ("prefill", 128, 1)


@pytest.mark.parametrize("m", [17, 64, 130, 512])
@pytest.mark.parametrize("n,k", [(1024, 4096), (4096, 14336), (336, 512)])
@pytest.mark.parametrize("sms", [114, 132])
def test_prefill_plan_fills_the_card_in_whole_steps(m, n, k, sms):
    """Mixtral's attn_v (N=1024, K=4096), a Q6_K-style down projection and a
    small matrix: the prefill grid holds a block for every SM where K has the
    steps for it, and its splits cover K in whole 64-row steps."""
    plan = w8_plan(m, n, k, sms)
    tiles = -(-m // plan.tile) * -(-n // PREFILL_COLUMNS)
    steps = k // PREFILL_STEP
    assert tiles * plan.splits >= min(sms, tiles * steps)
    assert 1 <= plan.splits <= steps
    spans = split_steps(k, plan.splits, PREFILL_STEP)
    assert spans[0][0] == 0 and spans[-1][1] == steps
    assert all(b == c for (_, b), (c, _) in zip(spans, spans[1:]))
    assert all(b > a for a, b in spans)


@pytest.mark.parametrize("m,n,k,gs", [(512, 1024, 4096, 32), (512, 4096, 14336, 16),
                                      (130, 1024, 4096, 32), (2048, 14336, 4096, 32)])
def test_prefill_plan_is_the_cheapest_that_fills_the_card(m, n, k, gs):
    """The row tile and K splits w8_plan picks read no more from L2 on the
    busiest SM (prefill_cost) than any other tile and split count that gives
    every SM a block; Mixtral's attn_v keeps 64-row tiles, a 512-row Q6_K-style
    down projection takes 128-row ones."""
    plan = w8_plan(m, n, k, 132, gs=gs)
    cost = prefill_cost(m, n, k, plan.tile, plan.splits, 132, gs)
    for tile in (64, 128):
        tiles = -(-m // tile) * -(-n // PREFILL_COLUMNS)
        for s in range(1, k // PREFILL_STEP + 1):
            if tiles * s >= min(132, tiles * (k // PREFILL_STEP)):
                assert cost <= prefill_cost(m, n, k, tile, s, 132, gs)
    if (m, n) == (512, 1024):
        assert plan.tile == 64
    if (m, n) == (512, 4096):
        assert plan.tile == 128


def test_attn_v_prefill_grid():
    """Mixtral's attn_v at M = 17, 64 and 512 gets at least 132 blocks."""
    for m in (17, 64, 512):
        plan = w8_plan(m, 1024, 4096, 132)
        assert -(-m // plan.tile) * (1024 // PREFILL_COLUMNS) * plan.splits >= 132


@pytest.mark.parametrize("n", [4096, 320])
def test_grouped_plan(n):
    """A bank's 16-row tiles take the decode body with one split (128-column
    blocks where the worst case of used tiles reaches 2 blocks per SM: 9
    tiles of Mixtral's decode x 32 column tiles); its 64-row tiles take the
    prefill body in pairs of one expert's tiles."""
    mp16 = 144  # build_groups' rows for 8 tokens, top-2 over 8 experts
    dec = w8_plan(mp16, n, 14336, 132, tm=16)
    assert (dec.body, dec.tile, dec.splits) == ("decode", 16, 1)
    assert dec.columns == (W8_DECODE_COLUMNS if n == 4096 else DECODE_COLUMNS)
    pre = w8_plan(1536, n, 14336, 132, tm=64)
    assert (pre.body, pre.tile, pre.splits, pre.columns) == (
        "prefill", W8_GROUPED_PREFILL_TILE, 1, PREFILL_COLUMNS)
    with pytest.raises(ValueError, match="row tile"):
        w8_plan(96, n, 512, 132, tm=32)


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


def _prefill_pair(word: torch.Tensor, lo: int, hi: int, signed: bool, s: torch.Tensor,
                  b) -> torch.Tensor:
    """The prefill body's bf16 pair of bytes ``lo`` and ``hi`` of the code
    word (int64 holding 32 bits): XOR 0x80808080 for signed codes, each byte
    by prmt into 0x4B0000uu (2^23 + u as f32), less 2^23 (or 2^23 + 128),
    then scale * q and + bias rounded to f32 each, the pair rounded to bf16
    (low half: byte ``lo``)."""
    if signed:
        word = word ^ 0x80808080
    out = []
    for sel in (lo, hi):
        f = (((word >> (8 * sel)) & 0xFF) | 0x4B000000).to(torch.int32).view(torch.float32)
        q = f - torch.tensor(8388736.0 if signed else 8388608.0, dtype=torch.float32)
        w = q * s
        out.append(w if b is None else w + b)
    return torch.stack(out, -1).to(torch.bfloat16)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("gs", [16, 32])
@pytest.mark.parametrize("signed", [False, True])
def test_prefill_weight_equals_plain_for_every_byte(signed, gs, bias):
    """Every byte value in every byte of the lane's code word (ldmatrix.trans
    gives lane (g, q) the bytes (k 2q, column 2g), (2q, 2g+1), (2q+1, 2g),
    (2q+1, 2g+1)): the A fragment's pairs, bytes 0 and 2 (column 2g at k 2q,
    2q+1) and bytes 1 and 3 (column 2g + 1), equal the plain version's bf16
    weights bit for bit."""
    rng = np.random.default_rng(gs + 2 * signed + 4 * bias)
    k, n = 1024, 2  # each column holds every byte value 4 times, shuffled
    vals = np.arange(-128, 128) if signed else np.arange(256)
    data = np.stack([rng.permutation(np.tile(vals, k // 256)) for _ in range(n)], 1).astype(
        np.int8 if signed else np.uint8)
    scale = (rng.random((k // gs, n)) * 0.02).astype(np.float32)
    bplane = (-64 * scale * rng.random(scale.shape)).astype(np.float32) if bias else None
    qt = QTensor(torch.from_numpy(data), torch.from_numpy(scale),
                 None if bplane is None else torch.from_numpy(bplane), group_size=gs,
                 packed=False, code_bits=8)
    want = qt.dequantize(torch.float32).to(torch.bfloat16).T  # [K, N]
    byte = torch.from_numpy(data.view(np.uint8).astype(np.int64))  # [K, N]
    word = byte[0::2, 0] | byte[0::2, 1] << 8 | byte[1::2, 0] << 16 | byte[1::2, 1] << 24
    s = qt.scale.repeat_interleave(gs, 0)[0::2]  # [K / 2, N]: each pair's group
    b = None if qt.bias is None else qt.bias.repeat_interleave(gs, 0)[0::2]
    for col, (lo, hi) in enumerate(((0, 2), (1, 3))):
        got = _prefill_pair(word, lo, hi, signed, s[:, col], None if b is None else b[:, col])
        ref = torch.stack([want[0::2, col], want[1::2, col]], -1)
        assert torch.equal(got.view(torch.int16), ref.contiguous().view(torch.int16))


_FORMATS = ["s8_gs16", "s8_gs32", "s8_gs16_bias", "u8_bias"]


def _bank(fmt, e, n, k, seed):
    """A W8 bank in both packages: Q6_K-style (signed, group 16), Q8_0-style
    (group 32), the widened form (signed with bias) or unsigned with bias."""
    rng = np.random.default_rng(seed)
    gs = 16 if "gs16" in fmt else 32 if "gs32" in fmt else 16
    signed = fmt.startswith("s8")
    lo = -128 if signed else 0
    data = rng.integers(lo, lo + 256, (e, k, n)).astype(np.int8 if signed else np.uint8)
    scale = ((0.5 + rng.random((e, k // gs, n))) / 64).astype(np.float32)
    bias = ((-0.5 + rng.random(scale.shape)) * 64 * scale).astype(np.float32) \
        if fmt.endswith("bias") else None
    tq = QTensor(torch.from_numpy(data), torch.from_numpy(scale),
                 None if bias is None else torch.from_numpy(bias), group_size=gs,
                 packed=False, code_bits=8)
    jq = JaxQTensor(jnp.asarray(data), jnp.asarray(scale),
                    None if bias is None else jnp.asarray(bias), group_size=gs, packed=False,
                    code_bits=8)
    return tq, jq, signed


@pytest.mark.parametrize("routing", ["ragged", "empty_expert", "all_to_one"])
@pytest.mark.parametrize("fmt", _FORMATS)
def test_grouped_decode_arithmetic_matches_plain_and_jax(fmt, routing):
    """The grouped decode body at 16-row tiles: per used tile, the decode
    arithmetic on the expert ``tile_idx`` names, zeros past ``n_used``;
    against the port's plain grouped version and the JAX package's grouped
    matmul (1e-2 of the largest output), and tile by tile against JAX
    ``_deq_dot`` (1e-5)."""
    e, n, k, ntok = 4, 96, 512, 12
    tq, jq, signed = _bank(fmt, e, n, k, seed=len(fmt) + len(routing))
    rng = np.random.default_rng(7)
    topi = rng.integers(0, e, (ntok, 2))
    if routing == "all_to_one":
        topi[:] = e - 1
    elif routing == "empty_expert":
        topi[topi == 1] = 2
    topw = rng.random((ntok, 2)).astype(np.float32)
    st, dest, _, tiles, n_used, mp = build_groups(torch.from_numpy(topi), torch.from_numpy(topw),
                                                  e, 16)
    x = torch.from_numpy(rng.standard_normal((ntok, k)).astype(np.float32)).to(torch.bfloat16)
    xs = torch.zeros((mp, k), dtype=torch.bfloat16)
    xs[dest] = x[st]
    used = int(n_used)
    assert used < mp // 16  # some tiles are unused: the model must leave them zero
    got = torch.zeros((mp, n), dtype=torch.float32)
    gs = tq.group_size
    for t in range(used):
        rows = slice(16 * t, 16 * t + 16)
        ex = int(tiles[t])
        got[rows] = _decode_body_model(xs[rows], tq.bank(ex), signed)
        # the tile against JAX's f32dot_bias on the same expert's planes
        q = tq.data[ex].numpy().astype(np.int32)
        b = (tq.bias[ex] if tq.bias is not None else torch.zeros_like(tq.scale[ex])).numpy()
        ref_t = np.asarray(jax_qm._deq_dot(jnp.asarray(xs[rows].float().numpy(), jnp.bfloat16),
                                           jnp.asarray(q), jnp.asarray(tq.scale[ex].numpy()),
                                           jnp.asarray(b), gs, jnp.bfloat16))
        np.testing.assert_allclose(got[rows].numpy(), ref_t,
                                   atol=1e-5 * max(np.abs(ref_t).max(), 1e-30))
    assert not got[16 * used:].any()
    plain = quant_matmul_grouped_plain(xs, tq, tiles, tm=16, n_used_tiles=n_used,
                                       out_dtype=torch.float32)
    tol = 1e-2 * plain.abs().max().item()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=tol)
    ref = np.asarray(jax_qm.quant_matmul_grouped(
        jnp.asarray(xs.float().numpy(), jnp.bfloat16), jq, jnp.asarray(tiles.numpy()), tm=16,
        backend="xla", out_dtype=jnp.float32))
    # the JAX function multiplies every tile (unused ones: zero padding rows)
    np.testing.assert_allclose(got.numpy(), ref, atol=tol)


# ---------------------------------------------------------------------------
# the e4m3 form (FP8 weights)
# ---------------------------------------------------------------------------


def _e4m3_to_f32(byte: torch.Tensor) -> torch.Tensor:
    """The kernels' e4m3x4: the hardware fp8 -> f16 conversion (exact: every
    e4m3 value, subnormals included, is an f16 normal or zero), then f16 ->
    f32."""
    return byte.to(torch.uint8).view(torch.float8_e4m3fn).to(torch.float16).to(torch.float32)


def test_e4m3_byte_to_bf16_is_exact_for_every_byte():
    """Every e4m3 byte but the two NaNs: f16 -> f32 -> bf16 (the decode
    body's A fragments) gives the byte's value exactly; and the prefill
    body's bf16(scale * q), scale * q rounded to f32 first, is the plain
    version's weight (``Fp8Tensor.dequantize``, f32 product then bf16) bit
    for bit at several scales."""
    from mistralrs_tpu_torch.quant.fp8 import Fp8Tensor

    byte = torch.arange(256)
    keep = (byte != 0x7F) & (byte != 0xFF)
    exact = byte.to(torch.uint8).view(torch.float8_e4m3fn).to(torch.float64)[keep]
    q = _e4m3_to_f32(byte)[keep]
    assert torch.equal(q.to(torch.float64), exact)
    assert torch.equal(q.to(torch.bfloat16).to(torch.float64), exact)
    for s in (1.0, 3.0e-4, 0.7071, 448.0 ** -1):
        data = byte[keep].to(torch.uint8).view(torch.float8_e4m3fn).reshape(-1, 1)  # [K, 1]
        data = data.expand(-1, 16).contiguous()
        fw = Fp8Tensor(data, torch.tensor(s, dtype=torch.float32))
        kernel = (torch.tensor(s, dtype=torch.float32) * q).to(torch.bfloat16)
        assert torch.equal(fw.dequantize(torch.bfloat16)[0], kernel)


@pytest.mark.parametrize("blocks,k", [(None, 4096), ((128, 128), 4096), ((128, 128), 14336),
                                      ((64, 64), 512)])
def test_e4m3_plan_is_the_w8_plan(blocks, k):
    """An FP8 weight takes the W8 kernel's plan at its group size (the block
    or K), without a bias plane; the split state the engine reserves covers
    it."""
    from mistralrs_tpu_torch.ops.quant_matmul import _plan, split_need_tree, split_sizes
    from mistralrs_tpu_torch.quant.fp8 import Fp8Tensor

    n = 4096
    fw = Fp8Tensor(torch.zeros((k, n), dtype=torch.float8_e4m3fn),
                   torch.ones(() if blocks is None else (n // blocks[0], k // blocks[1])),
                   blocks)
    gs = k if blocks is None else blocks[1]
    assert fw.group_size == gs and tuple(fw.plane.shape) == (k // gs, n)
    for m in (1, 8, 512):
        assert _plan(fw, m, 132) == w8_plan(m, n, k, 132, None, gs, False)
    need = split_need_tree({"layers": [{"wq": fw}]}, (1, 8, 512), 132)
    assert need == tuple(max(split_sizes(w8_plan(m, n, k, 132, None, gs, False), m, n)[i]
                             for m in (1, 8, 512)) for i in range(2))
