"""The W4 and W8 kernels' wide-group forms on the card (marked ``cuda``;
they skip where there is no GPU), against their plain PyTorch versions:

    python -m pytest tests/test_torch_cuda_gptq.py -q -m cuda --noconftest

W4 at groups 64 and 128, W8 at 64, 128 and per-column (g = K), in both
bodies: the decode body (M <= 16; K split into whole steps, so a split can
cut a group that spans several steps) and the prefill bodies (M > 16; the
W8 body's K splits too), with and without a bias plane, bf16 and f32
output, W8 in unsigned and signed codes. Then layers decoded from GPTQ
(4- and 8-bit) and AWQ words drawn on the card, through ``quant_matmul``.
Tolerances as ``tests/test_torch_cuda_kernels.py`` states them: 1e-2 of the
largest |output| (the decode body never rounds the weight; the W4 prefill
body rounds it within an f32 ulp of the plain version's value, the W8
prefill body exactly as the plain version does); the K splits are summed
in split order, so a second call gives the same bits.
"""

import pytest
import torch

from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.quant_matmul import quant_matmul, split_steps, w4_plan, w8_plan
from mistralrs_tpu_torch.quant import gptq_awq
from mistralrs_tpu_torch.quant.qtensor import QTensor

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _planes(n, k, gs, fmt, dev, bias=True, seed=0):
    """Planes of one matrix: "w4" split-half packed nibbles, "u8" unsigned
    bytes over all 256 values, "s8" signed bytes; scales of weights of
    variance ~1/K, bias (when asked) centring the codes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if fmt == "w4":
        data = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
        mid, var = 7.5, 21.25
    else:
        lo, dt = (0, torch.uint8) if fmt == "u8" else (-128, torch.int8)
        data = torch.randint(lo, lo + 256, (k, n), generator=g, device=dev,
                             dtype=torch.int32).to(dt)
        mid, var = (127.5 if fmt == "u8" else -0.5), 5461.25
    scale = (0.75 + 0.5 * torch.rand((k // gs, n), generator=g, device=dev)) / (var * k) ** 0.5
    return QTensor(data, scale, -mid * scale if bias else None, group_size=gs,
                   packed=fmt == "w4", code_bits=4 if fmt == "w4" else 8)


def _check(qt, m, dev, out_dtype=None, seed=1):
    x = torch.randn((m, qt.in_features), generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev).to(torch.bfloat16)
    reset_counts()
    got = quant_matmul(x, qt, out_dtype=out_dtype)
    again = quant_matmul(x, qt, out_dtype=out_dtype)
    ref = quant_matmul(x, qt, plain=True, out_dtype=out_dtype)
    torch.cuda.synchronize()
    name = ("w4_matmul" if qt.packed else "w8_matmul") + "_wide"
    assert COUNTS[name] == 2 and COUNTS[name + "_plain"] == 1
    assert got.dtype == (out_dtype or torch.bfloat16) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item()


# (N, K): one step of K, N not a multiple of 64; Llama-3-8B's o-proj (K
# split into whole steps, splits that do not divide them); a 1024-column
# matrix whose decode splits cut every group of 128; Qwen2.5-7B's down
# (K = 18944 = 148 steps, K/2 = 74 groups of 128)
SHAPES = {"336x512": (336, 512), "1024x4096": (1024, 4096), "4096x4096": (4096, 4096),
          "3584x18944": (3584, 18944)}
KINDS = {"w4_g64": ("w4", 64), "w4_g128": ("w4", 128), "u8_g64": ("u8", 64),
         "u8_g128": ("u8", 128), "s8_g128": ("s8", 128), "u8_gK": ("u8", 0),
         "s8_g64": ("s8", 64)}


@pytest.mark.parametrize("variant", ["bias_bf16", "nobias_bf16", "bias_f32"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("m", [1, 8, 16, 17, 64, 130, 512])
@pytest.mark.parametrize("kind", list(KINDS))
def test_wide_groups_match_plain(dev, kind, m, shape, variant):
    fmt, gs = KINDS[kind]
    n, k = SHAPES[shape]
    qt = _planes(n, k, gs or k, fmt, dev, bias=variant.startswith("bias"))
    _check(qt, m, dev, torch.float32 if variant.endswith("f32") else None)


def test_decode_splits_cut_groups():
    """The decode body's K splits at the 1024 x 4096 shape above cut groups
    (on a card of 132 SMs): W4 at group 128 spans 2 steps and some split
    begins at an odd step; W8 per-column has one group, which every split
    cuts."""
    w4 = w4_plan(8, 1024, 4096)
    assert w4.body == "decode" and w4.splits > 1
    assert any(a % 2 for a, _ in split_steps(4096, w4.splits))
    assert w8_plan(8, 1024, 4096, gs=4096, bias=True).splits > 1


def _words(shape, g):
    """int32 words over the full 32-bit range (bit 31 set in about half)."""
    return torch.randint(-2**31, 2**31, shape, generator=g, device=g.device, dtype=torch.int64
                         ).to(torch.int32)


@pytest.mark.parametrize("m", [1, 8, 130])
@pytest.mark.parametrize("case", ["gptq4", "gptq8", "gptq4_v2", "gptq8_per_column", "awq"])
def test_decoded_layers_through_the_kernels(dev, case, m):
    """Layers decoded on the card from GPTQ/AWQ words at Llama-3-8B's o-proj
    (4096 x 4096, group 128; per-column: g = K) through ``quant_matmul``:
    W4 for 4-bit (K/2 % 128 == 0), W8 unsigned with a bias plane for 8-bit
    and per-column, against the plain version."""
    g = torch.Generator(device=dev).manual_seed(3)
    n = k = 4096
    bits = 8 if "gptq8" in case else 4
    per = 32 // bits
    groups = 1 if "per_column" in case else k // 128
    scales = ((0.75 + 0.5 * torch.rand((groups, n), generator=g, device=dev))
              / (k * 21.25 * (16 if bits == 8 else 1)) ** 0.5).to(torch.float16)
    if case == "awq":
        qt = gptq_awq.awq_to_qtensor(_words((k, n // 8), g), _words((groups, n // 8), g), scales)
    else:
        qt = gptq_awq.gptq_to_qtensor(_words((k // per, n), g), _words((groups, n // per), g),
                                      scales, bits=bits, zero_offset=0 if "v2" in case else 1)
    assert qt.device.type == "cuda" and qt.group_size == k // groups
    assert qt.packed == (bits == 4 and groups > 1)
    _check(qt, m, dev)
