"""The W8 kernel's e4m3 form and HQQ planes on the card (marked ``cuda``;
they skip where there is no GPU):

    python -m pytest tests/test_torch_cuda_fp8_hqq.py -q -m cuda --noconftest

* FP8 weights (``quant/fp8.py``) through the W8 kernel's e4m3 form against
  the plain version (JAX ``fp8_matmul``: each weight rounded once to bf16,
  an f32 product) within 1e-2 of the largest |output|: M = 1, 8, 17 and
  512 (the decode body at 16 rows or fewer, the prefill body above),
  per-tensor and 128 x 128 blockwise scales, block 64, K = 128 and 14336,
  bf16 and f32 output; each body's launch counted.
* Every e4m3 byte but the two NaNs through both bodies with one-hot rows of
  x: each output is one weight, and must equal the plain version's bit for
  bit (the conversion is exact).
* Shapes the kernel refuses raise: a block of 96 rows of K, K not a multiple
  of 128, N not a multiple of 16.
* HQQ planes (``quant/hqq.py``, quantized on the card) on the W4 and W8
  kernels' wide-group forms (4-bit group 64 and 128, 3-bit group 64 in
  nibbles, 8-bit group 64) at M = 1, 8, 17 and 512 against the plain
  version, 1e-2 of the largest |output|; a group of 256 at 4 bits raises
  by name.
"""

import pytest
import torch

from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.quant.fp8 import Fp8Tensor, fp8_matmul
from mistralrs_tpu_torch.quant.linear import linear

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    tol = 1e-2 * ref.float().abs().max().item()
    assert torch.isfinite(got).all() and err <= tol, (err, tol)


@pytest.mark.parametrize("m", [1, 8, 17, 512])
@pytest.mark.parametrize("k", [128, 14336])
@pytest.mark.parametrize("blocks", [None, (128, 128), (64, 64)])
def test_e4m3_against_plain(dev, m, k, blocks):
    gen = torch.Generator(device=dev).manual_seed(m + k)
    n = 4096 if k == 14336 else 336
    w = torch.randn((n, k), generator=gen, device=dev) / k ** 0.5
    fw = Fp8Tensor.quantize(w, blocks, device=dev)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    for out_dtype in (torch.bfloat16, torch.float32):
        reset_counts()
        got = fp8_matmul(x, fw, out_dtype=out_dtype)
        body = "decode" if m <= 16 else "prefill"
        assert COUNTS["w8_matmul_e4m3"] == 1 and COUNTS[f"w8_matmul_e4m3.{body}"] == 1
        assert COUNTS["w8_matmul_e4m3_plain"] == 0
        _close(got, fp8_matmul(x, fw, out_dtype=out_dtype, plain=True))
        assert got.dtype == out_dtype


@pytest.mark.parametrize("m", [8, 64])
def test_every_e4m3_byte_exact(dev, m):
    k, n = 256, 256
    codes = torch.arange(k * n, device=dev).reshape(k, n) % 256
    codes[(codes == 0x7F) | (codes == 0xFF)] = 0  # the NaNs
    data = codes.to(torch.uint8).view(torch.float8_e4m3fn)
    fw = Fp8Tensor(data.contiguous(), torch.tensor(1.0, device=dev))
    rows = torch.arange(m, device=dev) * 3 % k
    x = torch.zeros((m, k), device=dev, dtype=torch.bfloat16)
    x[torch.arange(m), rows] = 1.0
    got = fp8_matmul(x, fw, out_dtype=torch.float32)
    assert torch.equal(got, fp8_matmul(x, fw, out_dtype=torch.float32, plain=True))
    assert torch.equal(got, data.to(torch.float32)[rows])


@pytest.mark.parametrize("shape,blocks", [((256, 384), (128, 96)), ((256, 200), None),
                                          ((40, 256), None)])
def test_refused_shapes_raise(dev, shape, blocks):
    w = torch.randn(shape, device=dev)
    fw = Fp8Tensor.quantize(w, blocks, device=dev)
    x = torch.randn((4, shape[1]), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError):
        fp8_matmul(x, fw)


def test_linear_takes_fp8(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn((512, 1024), generator=gen, device=dev) / 32
    fw = Fp8Tensor.quantize(w, (128, 128), device=dev)
    x = torch.randn((2, 5, 1024), generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(512, generator=gen, device=dev)
    _close(linear(x, fw, bias), linear(x, fw, bias, plain=True))


@pytest.mark.parametrize("bits,group", [(4, 64), (4, 128), (8, 64), (3, 64)])
@pytest.mark.parametrize("m", [1, 8, 17, 512])
def test_hqq_planes_on_the_wide_forms(dev, bits, group, m):
    """HQQ planes quantized on the card: 4- and 3-bit codes packed on W4's
    wide form, 8-bit on W8's, each against the plain version."""
    from mistralrs_tpu_torch.ops.quant_matmul import quant_matmul
    from mistralrs_tpu_torch.quant.hqq import hqq_quantize

    gen = torch.Generator(device=dev).manual_seed(bits * group + m)
    w = torch.randn((1024, 4096), generator=gen, device=dev) / 64
    qt = hqq_quantize(w, bits, group, device=dev)
    assert qt.packed == (bits <= 4)
    x = torch.randn((m, 4096), generator=gen, device=dev).to(torch.bfloat16)
    reset_counts()
    got = quant_matmul(x, qt)
    name = ("w4_matmul_wide" if bits <= 4 else "w8_matmul_wide")
    assert COUNTS[name] == 1 and COUNTS[name + "_plain"] == 0
    _close(got, quant_matmul(x, qt, plain=True))


def test_hqq_group_the_kernels_refuse_raises(dev):
    from mistralrs_tpu_torch.quant.hqq import hqq_quantize

    with pytest.raises(ValueError, match="W4 kernel"):
        hqq_quantize(torch.randn((64, 512), device=dev), 4, 256, device=dev)
