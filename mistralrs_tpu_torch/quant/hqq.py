"""HQQ, half-quadratic quantization (counterpart of
``mistralrs_tpu/quant/hqq.py``), on the device.

Group-wise affine quantization along the flattened ``[N, K]`` weight,
``w ~ scale * (q - zero)``, whose zero points are refined by HQQ's
half-quadratic solver (a proximal step for an l_p error, p < 1, then the
zero that best fits the shrunk error). The result is the planar form of
every other format, ``value = scale * code + bias`` with ``bias = -scale *
zero``: unsigned codes of ``bits`` bits and a bias plane, which the W4
kernel's wide-group form takes at 4 bits (and 2 and 3: codes in nibbles)
and groups of 64 or 128, and the W8 kernel at 5 to 8 bits and groups of 16,
32, 64 or a multiple of 128 dividing K. Other group sizes and bit widths
raise by name (the kernels' rule, ``ops/quant_matmul.py::group_error``):
nothing would run them but the plain version.

:func:`hqq_quantize` follows the numpy reference op for op in f32, its
divisions by tensors (exact on the card too); the scale plane is the JAX
package's bit for bit. ``pow`` and the group means may round differently
in their last bit, which moves a zero point by an ulp, so a code that lies
at a rounding tie can differ by one (the tests bound the share).
"""

from __future__ import annotations

import torch

from .._device import DeviceLike, resolve_device
from ..gguf.planar import PlanarQuant
from ..ops.quant_matmul import group_error
from .qtensor import QTensor


def _check_form(bits: int, group_size: int, k: int) -> None:
    if not 1 <= bits <= 8:
        raise ValueError(f"HQQ at {bits} bits: the W4/W8 kernels take 1 to 8-bit codes")
    why = group_error(bits <= 4 and (k // 2) % group_size == 0, group_size, k)
    if why is not None:
        raise ValueError(f"HQQ {bits}-bit at group {group_size}: {why}")


def _shrink_lp(x: torch.Tensor, beta: float, p: float) -> torch.Tensor:
    """The generalized soft threshold of the l_p (p < 1) proximal step."""
    ax = x.abs()
    return torch.sign(x) * torch.clamp(ax - (1.0 / beta) * torch.pow(ax + 1e-8, p - 1.0), min=0.0)


def hqq_quantize(w: torch.Tensor, bits: int = 4, group_size: int = 64, iters: int = 20,
                 lp_norm: float = 0.7, beta: float = 10.0, kappa: float = 1.01,
                 device: DeviceLike = None) -> QTensor:
    """Quantize ``w [N, K]`` on ``device`` (``cuda`` unless the caller asks
    for ``"cpu"``) to HQQ planes with solver-refined zero points (JAX
    ``hqq_quantize``, HQQ Algorithm 1, ``iters`` steps)."""
    dev = resolve_device(device)
    n, k = w.shape
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group {group_size}")
    _check_form(bits, group_size, k)
    g = w.to(device=dev, dtype=torch.float32).reshape(-1, group_size)
    maxq = (1 << bits) - 1
    wmin = g.amin(dim=1, keepdim=True)
    wmax = g.amax(dim=1, keepdim=True)
    scale = (wmax - wmin) / torch.tensor(float(maxq), device=dev)
    scale = torch.where(scale == 0, torch.tensor(1e-8, device=dev), scale)
    zero = -wmin / scale  # the zero point in code space
    b = beta
    for _ in range(iters):
        q = torch.clamp(torch.round(g / scale + zero), 0, maxq)
        e = _shrink_lp(g - (q - zero) * scale, b, lp_norm)
        zero = torch.mean(q - (g - e) / scale, dim=1, keepdim=True)
        b *= kappa
    q = torch.clamp(torch.round(g / scale + zero), 0, maxq).to(torch.uint8)
    planar = PlanarQuant(q=q.reshape(-1), scale=scale[:, 0], bias=(-scale * zero)[:, 0],
                         group_size=group_size, code_bits=bits, signed=False)
    return QTensor.from_planar(planar, (n, k), device=dev)


def hqq_from_state(w_q, scale, zero, shape: tuple[int, int], bits: int = 4,
                   group_size: int = 64, device: DeviceLike = None) -> QTensor:
    """A QTensor on ``device`` from saved HQQ state (hqq-lib's convention,
    ``W ~ (W_q - zero) * scale`` group-wise along the flattened weight; one
    unpacked code a byte), as JAX ``hqq_from_state`` builds it: bias =
    ``-scale * zero`` in f32."""
    dev = resolve_device(device)
    _check_form(bits, group_size, shape[1])
    q = torch.as_tensor(w_q).to(device=dev, dtype=torch.uint8).reshape(-1)
    s = torch.as_tensor(scale).to(device=dev, dtype=torch.float32).reshape(-1)
    z = torch.as_tensor(zero).to(device=dev, dtype=torch.float32).reshape(-1)
    planar = PlanarQuant(q=q, scale=s, bias=-s * z, group_size=group_size, code_bits=bits,
                         signed=False)
    return QTensor.from_planar(planar, tuple(shape), device=dev)
