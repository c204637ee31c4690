"""In-situ quantization on the card (marked ``cuda``; they skip where there
is no GPU):

    python -m pytest tests/test_torch_cuda_isq.py -q -m cuda --noconftest

* Each ISQ type's quantizer (``gguf/quants.py``: Q8_0, Q4_0, Q5_0, Q4_K,
  Q5_K, Q6_K; Q4_K and Q5_K also with importance weights) run on the card
  gives the bytes the port's CPU run gives for the same input, bit for bit:
  normal and Student-t rows, an all-zero and a constant super-block,
  all-positive groups and magnitudes whose f16 ``d`` is subnormal.
* Routers and gates whose N is not a multiple of 16 (N = 8, 60 and 1),
  quantized in situ on the card and zero-padded to 16-row multiples: the W4
  (Q4_K) and W8 (Q5_K, Q8_0) kernels at M = 1, 8 and 130 against the plain
  version on the same planes, within 1e-2 of the largest |output|, the
  output sliced to N by ``quant/linear.py::linear``.
"""

import pytest
import torch

from mistralrs_tpu_torch.gguf.constants import GGMLType
from mistralrs_tpu_torch.gguf.quants import quantize
from mistralrs_tpu_torch.models.hf_loader import _quantize_tensor
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.quant.linear import linear

pytestmark = pytest.mark.cuda

TYPES = ["Q8_0", "Q4_0", "Q5_0", "Q4_K", "Q5_K", "Q6_K"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dev) -> torch.Tensor:
    """[96, 1024] f32 on the card: the CPU tests' kinds of rows."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((96, 1024), generator=gen, device=dev) * 0.02
    x[16:32] = x[16:32] / (torch.rand((16, 1024), generator=gen, device=dev) + 0.05)
    x[32, :256] = 0.0
    x[33, :256] = -0.25
    x[34] = x[34].abs() + 0.05
    x[64:80] *= 5e-3  # d subnormal in f16
    return x


@pytest.mark.parametrize("name", TYPES)
def test_card_bytes_equal_cpu(dev, name):
    x = _inputs(dev)
    got = quantize(x, GGMLType[name])
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), quantize(x.cpu(), GGMLType[name]))


@pytest.mark.parametrize("name", ["Q4_K", "Q5_K"])
def test_card_imatrix_bytes_equal_cpu(dev, name):
    x = _inputs(dev)
    w = torch.rand(x.shape[-1], generator=torch.Generator(device=dev).manual_seed(1),
                   device=dev) ** 3
    got = quantize(x, GGMLType[name], w)
    assert torch.equal(got.cpu(), quantize(x.cpu(), GGMLType[name], w.cpu()))


@pytest.mark.parametrize("name,kernel", [("Q4_K", "w4_matmul"), ("Q5_K", "w8_matmul"),
                                         ("Q8_0", "w8_matmul")])
@pytest.mark.parametrize("n", [8, 60, 1])
def test_padded_router_on_the_kernels(dev, name, kernel, n):
    gen = torch.Generator(device=dev).manual_seed(n)
    w = (torch.randn((n, 2048), generator=gen, device=dev) * 2048 ** -0.5).to(torch.bfloat16)
    qt = _quantize_tensor(w, GGMLType[name], dev)
    assert qt.logical_n == n and qt.out_features == -(-n // 16) * 16
    for m in (1, 8, 130):
        x = torch.randn((m, 2048), generator=gen, device=dev).to(torch.bfloat16)
        reset_counts()
        got = linear(x, qt)
        assert COUNTS[kernel] == 1 and got.shape == (m, n)
        ref = linear(x, qt, plain=True)
        tol = 1e-2 * ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() <= tol
