"""The W4 kernel's plan and arithmetic on the CPU.

``w4_plan`` is the pure function that picks the W4 kernel's body, row tile
and K splits; these tests pin what the card's kernel relies on: every
Llama-3-8B decode shape fills the card with >= 2 blocks per SM, the splits
cover K in whole steps, M <= 16 takes the decode body. The decode body takes
the k-quant scale and "min" bias out of its inner loop as group sums of x
(the JAX kernel's ``f32dot_bias`` arithmetic); a plain model of that
arithmetic is held against ``quant_matmul_plain`` (the port's plain version,
which rounds the weight to bf16: 1e-2 of the largest output, the kernels'
stated tolerance) and against JAX ``_deq_dot`` (the same arithmetic in
another f32 order: 1e-5 of the largest output). The prefill body's dequant,
w = fma(s, 128 + q, b - 128 s) rounded to bf16, is held against the plain
version's weight: within one bf16 ulp, and equal for all but a few in ten
thousand (the two f32 sums round differently near a bf16 tie).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu_torch.ops import quant_matmul as qm
from mistralrs_tpu_torch.ops.quant_matmul import (
    DECODE_COLUMNS,
    DECODE_STEP,
    quant_matmul_plain,
    w4_plan,
    w4_split_rows,
)
from mistralrs_tpu_torch.quant.qtensor import QTensor

jax_qm = importlib.import_module("mistralrs_tpu.ops.quant_matmul")

LLAMA3_8B_DECODE = [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336)]


def _q4(n, k, seed=0, bias=True, e=None):
    rng = np.random.default_rng(seed)
    lead = () if e is None else (e,)
    data = torch.from_numpy(rng.integers(0, 256, (*lead, k // 2, n), dtype=np.uint8))
    scale = (0.5 + rng.random((*lead, k // 32, n))).astype(np.float32) / 64
    b = (-8.0 + rng.random(scale.shape).astype(np.float32)) * scale
    return QTensor(data, torch.from_numpy(scale), torch.from_numpy(b) if bias else None,
                   group_size=32, packed=True, code_bits=4)


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("n,k", LLAMA3_8B_DECODE)
def test_llama_decode_shapes_fill_the_card(n, k, m):
    plan = w4_plan(m, n, k, None, 132)
    assert plan.body == "decode"
    assert -(-n // DECODE_COLUMNS) * plan.splits >= 264


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("n,k", LLAMA3_8B_DECODE + [(1024, 4096), (320, 512), (4096, 128)])
def test_splits_cover_k_in_whole_steps(n, k, sms):
    plan = w4_plan(8, n, k, None, sms)
    rows = w4_split_rows(k, plan.splits)
    assert rows[0][0] == 0 and rows[-1][1] == k // 2
    for (a, b), (c, _) in zip(rows, rows[1:]):
        assert b == c
    for a, b in rows:
        assert b > a and a % (DECODE_STEP // 2) == 0 and b % (DECODE_STEP // 2) == 0
    assert 1 <= plan.splits <= k // DECODE_STEP


def test_uneven_splits_are_covered():
    """Mixtral's k-proj (N = 1024, K = 4096): 32 steps in 17 splits."""
    plan = w4_plan(8, 1024, 4096, None, 132)
    assert 4096 // DECODE_STEP % plan.splits != 0
    sizes = {b - a for a, b in w4_split_rows(4096, plan.splits)}
    assert sizes == {64, 128}


@pytest.mark.parametrize("m,body,tile", [(1, "decode", 8), (8, "decode", 8), (9, "decode", 16),
                                         (16, "decode", 16), (17, "prefill", 64),
                                         (64, "prefill", 64), (65, "prefill", 128),
                                         (130, "prefill", 128), (512, "prefill", 128)])
def test_rows_choose_the_body(m, body, tile):
    plan = w4_plan(m, 4096, 4096, None, 132)
    assert (plan.body, plan.tile) == (body, tile)
    assert plan.splits == 1 or body == "decode"


@pytest.mark.parametrize("tm,body", [(16, "decode"), (64, "prefill")])
def test_grouped_tiles(tm, body):
    plan = w4_plan(tm * 3, 28672, 4096, tm, 132)
    assert (plan.body, plan.tile, plan.splits) == (body, tm, 1)


def test_bad_grouped_tile_raises():
    with pytest.raises(ValueError):
        w4_plan(96, 4096, 4096, 32, 132)


@pytest.mark.parametrize("breakage", ["scale_shape", "scale_dtype", "bias_shape", "group_size",
                                      "codes_dtype", "k_steps", "n_multiple"])
def test_bad_planes_raise(breakage):
    """The once-per-QTensor plane check still refuses bad planes."""
    good = _q4(64, 256)
    data, scale, bias, gs = good.data, good.scale, good.bias, 32
    if breakage == "scale_shape":
        scale = scale[:, :32].contiguous()
    elif breakage == "scale_dtype":
        scale = scale.double()
    elif breakage == "bias_shape":
        bias = bias[:4].contiguous()
    elif breakage == "group_size":  # W4 takes groups of 16, 32, 64 and 128
        gs = 8
        scale = torch.ones((32, 64))
        bias = None
    elif breakage == "codes_dtype":
        data = data.to(torch.int16)
    elif breakage == "k_steps":
        data, scale, bias = data[:96].contiguous(), scale[:6].contiguous(), bias[:6].contiguous()
    elif breakage == "n_multiple":
        data, scale, bias = (data[:, :40].contiguous(), scale[:, :40].contiguous(),
                             bias[:, :40].contiguous())
    bad = QTensor(data, scale, bias, group_size=gs, packed=True, code_bits=4)
    with pytest.raises(ValueError):
        qm._plane_format(bad)


def test_planes_are_checked_once(monkeypatch):
    qt = _q4(64, 256)
    calls = []
    real = qm._check_planes
    monkeypatch.setattr(qm, "_check_planes", lambda q: calls.append(1) or real(q))
    assert qm._plane_format(qt) == qm._plane_format(qt) == qm._FMT_PACKED4
    assert len(calls) == 1
    assert qm._plane_format(_q4(64, 256, seed=1)) == qm._FMT_PACKED4
    assert len(calls) == 2


def _decode_body_model(x2, qt):
    """The decode body's arithmetic in f32: per group of 32, the bf16 pair
    128 + q times bf16 x summed exactly, then scale * that sum plus
    (bias - 128 * scale) * the group sum of x."""
    m, k = x2.shape
    n = qt.out_features
    q = qt.unpack_codes().to(torch.float32)  # [K, N]
    xb = x2.to(torch.bfloat16).to(torch.float64)
    g = k // 32
    tq = torch.einsum("mgi,gin->mgn", xb.reshape(m, g, 32),
                      (128.0 + q.to(torch.float64)).reshape(g, 32, n)).to(torch.float32)
    t1 = xb.reshape(m, g, 32).sum(-1).to(torch.float32)  # [M, G]
    s = qt.scale
    c = (qt.bias if qt.bias is not None else torch.zeros_like(s)) - 128.0 * s
    return (tq * s[None] + t1[:, :, None] * c[None]).sum(1)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("m", [1, 8, 16])
def test_decode_arithmetic_matches_plain_and_jax(m, bias):
    qt = _q4(96, 512, seed=m, bias=bias)
    x = torch.from_numpy(np.random.default_rng(100 + m).standard_normal((m, 512))
                         .astype(np.float32)).to(torch.bfloat16)
    got = _decode_body_model(x, qt)
    plain = quant_matmul_plain(x, qt, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(),
                               atol=1e-2 * plain.abs().max().item())
    # JAX's f32dot_bias: dot(x, q * s) + dot(group sums of x, b), in f32
    q = qt.unpack_codes().numpy().astype(np.int32)
    b = (qt.bias if bias else torch.zeros_like(qt.scale)).numpy()
    ref = np.asarray(jax_qm._deq_dot(jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(q),
                                     jnp.asarray(qt.scale.numpy()), jnp.asarray(b), 32,
                                     jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefill_dequant_matches_plain_weight(seed):
    """w = fma(s, 128 + q, b - 128 s) (exact product, one f32 rounding;
    b - 128 s rounded once in f32), rounded to bf16, against the plain
    version's bf16 weight."""
    qt = _q4(64, 256, seed=seed)
    q = qt.unpack_codes().to(torch.float64)  # [K, N]
    s = qt.scale.repeat_interleave(32, 0)
    c = qt.bias.repeat_interleave(32, 0) - 128.0 * s
    w = (s.double() * (128.0 + q) + c.double()).to(torch.float32).to(torch.bfloat16)
    plain = qt.dequantize(torch.float32).to(torch.bfloat16).T  # [K, N]
    ulp = plain.float().abs() * 2.0 ** -7
    assert ((w.float() - plain.float()).abs() <= ulp).all()
    assert int((w != plain).sum()) <= w.numel() // 1000
