"""In-situ quantizers: float weights → raw GGUF blocks, as torch ops on the
weights' device (the port's copy of the ISQ types of
``mistralrs_tpu/gguf/quants.py``: ``quant_q8_0`` :275, ``quant_q4_0`` and
``quant_q5_0`` :287-320, the k-quants' grid search ``_make_qkx2_quants``
:323 and ``_quant_k_affine`` :395, ``quant_q4_k`` / ``quant_q5_k`` :437-468,
``quant_q6_k`` :471, ``quant_q2_k`` / ``quant_q3_k`` :528-608 (the types a
topology may name), ``quantize`` :643 and ``quantize_imatrix`` :659).

The functions follow the numpy reference op for op, so that the bytes are
the reference's, bit for bit, on the CPU and on the card alike:

* rounding is llama.cpp's ``nearest_int``, ``sign(x) floor(|x| + 0.5)`` in
  f32, and a value numpy's int32 cast cannot hold becomes its ``INT_MIN``;
* every division by a constant divides by a tensor: PyTorch's CUDA division
  by a Python scalar multiplies by its reciprocal, which is not division;
* the order-dependent f32 and f64 sums over 16 or 32 elements are numpy's
  own order (:func:`_pairwise`: eight strided partials, then a tree), not
  ``torch.sum``'s; sums of integers, exact in f64, use ``torch.sum``;
* the f64 work (the grid search's refit and error) stays f64, the f32 work
  f32, and a Python factor multiplies as numpy's weak f32 scalar does;
* zeros out of a min or max reduction are +0, which is numpy's result
  whenever the last element of a tied group is +0 (always, for +0 inputs).

A tensor is processed in chunks of rows (:data:`CHUNK_WEIGHTS` weights), so
the grid search's f64 temporaries stay near a GB whatever its size.
"""

from __future__ import annotations

from typing import Optional

import torch

from .constants import GGMLType, type_traits

# weights per chunk of rows: the k-quants' grid search holds about ten f64
# temporaries of a chunk at once (~1.3 GB at 2^24)
CHUNK_WEIGHTS = 1 << 24

F32, F64 = torch.float32, torch.float64


class _Consts:
    """0-dim constants on one device, made once per quantize call (a tensor
    divisor divides exactly on the card; a Python one does not)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._cache: dict = {}

    def __call__(self, v: float, dtype=F32) -> torch.Tensor:
        key = (v, dtype)
        t = self._cache.get(key)
        if t is None:
            t = self._cache[key] = torch.tensor(v, dtype=dtype, device=self.device)
        return t


def _nearest_int(x: torch.Tensor) -> torch.Tensor:
    """llama.cpp's ``nearest_int`` (round half away from zero, in ``x``'s
    dtype) as floats; what an int32 cannot hold (and NaN) becomes
    ``-2^31``, as numpy's cast makes it on x86."""
    r = torch.sign(x) * torch.floor(x.abs() + 0.5)
    return torch.where(r.abs() < 2.0 ** 31, r, -2.0 ** 31)


def _clip_int(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``clip(nearest_int(x), lo, hi)`` as floats."""
    return _nearest_int(x).clamp(lo, hi)


def _safe_inv(d: torch.Tensor, k: _Consts, positive: bool = True) -> torch.Tensor:
    """``where(d > 0, 1 / d, 0)`` (``d != 0`` with ``positive=False``), in
    ``d``'s dtype, dividing exactly."""
    one, zero = k(1.0, d.dtype), k(0.0, d.dtype)
    ok = d > 0 if positive else d != 0
    return torch.where(ok, one / torch.where(ok, d, one), zero)


def _pairwise(x: torch.Tensor) -> torch.Tensor:
    """numpy's sum of each row (last axis of 16 or 32, contiguous): eight
    partials r_j = x_j + x_{j+8} + ..., then ((r0 + r1) + (r2 + r3)) +
    ((r4 + r5) + (r6 + r7))."""
    r = x[..., 0:8]
    for i in range(8, x.shape[-1], 8):
        r = r + x[..., i:i + 8]
    r = r[..., 0::2] + r[..., 1::2]
    r = r[..., 0::2] + r[..., 1::2]
    return r[..., 0] + r[..., 1]


def _f16_bytes(v: torch.Tensor) -> torch.Tensor:
    """f32 ``[n]`` or ``[n, 1]`` → its f16 as ``[n, 2]`` bytes."""
    return v.to(torch.float16).contiguous().view(torch.uint8).reshape(-1, 2)


def _pack_nibbles(c: torch.Tensor) -> torch.Tensor:
    """[n, 32] 4-bit codes → [n, 16] bytes: code j low, code j + 16 high."""
    return c[:, :16] | (c[:, 16:] << 4)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[n, 8 m] bits → [n, m] bytes, bit i of byte b from bits[:, 8 b + i]."""
    n = bits.shape[0]
    shifts = torch.arange(8, device=bits.device, dtype=torch.uint8)
    return (bits.reshape(n, -1, 8) << shifts).sum(-1, dtype=torch.int32).to(torch.uint8)


def _pack_scale_min_k4(sc: torch.Tensor, mn: torch.Tensor) -> torch.Tensor:
    """[n, 8] 6-bit scales and mins → the 12 packed bytes of Q4_K / Q5_K."""
    out = [(sc[:, g] & 63) | ((sc[:, g + 4] >> 4) << 6) for g in range(4)]
    out += [(mn[:, g] & 63) | ((mn[:, g + 4] >> 4) << 6) for g in range(4)]
    out += [(sc[:, g + 4] & 15) | ((mn[:, g + 4] & 15) << 4) for g in range(4)]
    return torch.stack(out, dim=1)


def _pack_q4k_nibbles(q: torch.Tensor) -> torch.Tensor:
    """[n, 256] 4-bit codes in element order → the 128 ``qs`` bytes of
    Q4_K / Q5_K: byte 32 c + j holds element 64 c + j (low nibble) and
    64 c + 32 + j (high)."""
    q = q.reshape(-1, 4, 2, 32)
    return (q[:, :, 0] | (q[:, :, 1] << 4)).reshape(-1, 128)


def _pack_q6k_codes(q6: torch.Tensor) -> torch.Tensor:
    """[n, 256] 6-bit codes (biased by 32) in element order → the 128
    ``ql`` and 64 ``qh`` bytes of Q6_K: element h 128 + q 32 + j has its low
    nibble in ``ql`` byte 64 h + 32 (q % 2) + j (high half for q >= 2) and
    its two high bits at bit 2 q of ``qh`` byte 32 h + j."""
    codes = q6.reshape(-1, 2, 4, 32)
    lo, hi = codes & 15, codes >> 4
    ql = torch.cat([lo[:, :, 0] | (lo[:, :, 2] << 4), lo[:, :, 1] | (lo[:, :, 3] << 4)], dim=2)
    qh = hi[:, :, 0] | (hi[:, :, 1] << 2) | (hi[:, :, 2] << 4) | (hi[:, :, 3] << 6)
    return torch.cat([ql.reshape(-1, 128), qh.reshape(-1, 64)], dim=1)


def _u8(q: torch.Tensor) -> torch.Tensor:
    """Integer-valued floats in [0, 255] → uint8."""
    return q.to(torch.int32).to(torch.uint8)


# ---------------------------------------------------------------------------
# the quantizers, on [n_blocks, block] f32
# ---------------------------------------------------------------------------


def _quant_q8_0(x: torch.Tensor, k: _Consts) -> torch.Tensor:
    amax = x.abs().amax(dim=1, keepdim=True)
    d = amax / k(127.0)
    q = _clip_int(x * _safe_inv(d, k), -127, 127).to(torch.int8)
    return torch.cat([_f16_bytes(d), q.view(torch.uint8)], dim=1)


def _quant_q4_family(x: torch.Tensor, nmax: int, k: _Consts):
    """Symmetric per-32 quantization, ``d = extreme / -2^(b-1)`` (its sign
    kept): ``(d [n, 1] f32, q [n, 32] codes as floats, biased by 2^(b-1))``."""
    half = (nmax + 1) // 2
    idx = x.abs().argmax(dim=1, keepdim=True)  # the first largest |x|
    d = x.gather(1, idx) / k(float(-half))
    q = (_nearest_int(x * _safe_inv(d, k, positive=False)) + half).clamp(0, nmax)
    return d, q


def _quant_q4_0(x: torch.Tensor, k: _Consts) -> torch.Tensor:
    d, q = _quant_q4_family(x, 15, k)
    return torch.cat([_f16_bytes(d), _pack_nibbles(_u8(q))], dim=1)


def _quant_q5_0(x: torch.Tensor, k: _Consts) -> torch.Tensor:
    d, q = _quant_q4_family(x, 31, k)
    q = _u8(q)
    return torch.cat([_f16_bytes(d), _pack_bits(q >> 4), _pack_nibbles(q & 15)], dim=1)


def _make_qkx2_quants(x: torch.Tensor, nmax: int, k: _Consts, w: Optional[torch.Tensor] = None,
                      rmin: float = -1.0, rdelta: float = 0.1, nstep: int = 20):
    """Affine quantization of each row of ``x`` (16 or 32 wide) to codes in
    [0, nmax] with value = scale * q - min: llama.cpp's ``make_qkx2_quants``
    grid search (JAX :323-392), with the optional per-element importance
    ``w`` (the weighted least-squares refit and error). Returns ``(scale [n]
    f32, min [n] f32, q [n, gs] codes as floats)``."""
    width = x.shape[1]
    vmax = x.amax(dim=1)
    vmax = torch.where(vmax != 0, vmax, k(0.0))  # a zero max as +0
    vmin = x.amin(dim=1)
    vmin = torch.where(vmin < 0, vmin, k(0.0))  # numpy's minimum(vmin, 0.0)
    flat = vmax == vmin
    span = (vmax - vmin) / k(float(nmax))
    scale = torch.where(flat, k(0.0), span)
    x64 = x.to(F64)
    xm = x - vmin[:, None]
    if w is None:
        sum_x = _pairwise(x).to(F64)
        wf = gs = None
    else:
        wf = w.to(F64)
        sum_x = _pairwise(wf * x64)
        gs = _pairwise(wf)
    best_err = torch.full_like(sum_x, float("inf"))
    best_scale, best_min = scale.to(F64), (-vmin).to(F64)
    best_q = None
    inv = _safe_inv(scale, k)
    one64 = k(1.0, F64)
    for step in range(nstep + 1):
        factor = (rmin + rdelta * step + nmax) / nmax
        trial_scale = span * factor
        trial_inv = torch.where(trial_scale > 0, k(1.0) / torch.where(trial_scale > 0,
                                                                      trial_scale, k(1.0)), inv)
        q = _clip_int(trial_inv[:, None] * xm, 0, nmax)
        qf = q.to(F64)
        if w is None:
            sum_l = qf.sum(dim=1)  # sums of integers: exact in any order
            sum_l2 = (qf * qf).sum(dim=1)
            sum_xl = _pairwise(qf * x64)
            D = sum_l2 * width - sum_l * sum_l
            num_scale = sum_xl * width - sum_x * sum_l
        else:
            wq = wf * qf
            sum_l = _pairwise(wq)
            sum_l2 = _pairwise(wq * qf)
            sum_xl = _pairwise(wq * x64)
            D = gs * sum_l2 - sum_l * sum_l
            num_scale = gs * sum_xl - sum_x * sum_l
        ok = D > 0
        Dd = torch.where(ok, D, one64)
        this_scale = torch.where(ok, num_scale / Dd, trial_scale.to(F64))
        this_min = torch.where(ok, (sum_l2 * sum_x - sum_l * sum_xl) / Dd, vmin.to(F64))
        pos_min = this_min > 0
        this_min = torch.where(pos_min, k(0.0, F64), this_min)
        refit = pos_min & ok & (sum_l2 > 0)
        this_scale = torch.where(refit, sum_xl / torch.where(sum_l2 > 0, sum_l2, one64),
                                 this_scale)
        diff = this_scale[:, None] * qf + this_min[:, None] - x64
        sq = diff * diff
        err = _pairwise(sq if w is None else wf * sq)
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best_scale = torch.where(better, this_scale, best_scale)
        best_min = torch.where(better, -this_min, best_min)
        best_q = q if best_q is None else torch.where(better[:, None], q, best_q)
    best_min = torch.where(best_min > 0, best_min, k(0.0, F64))  # numpy's maximum(m, 0.0)
    return best_scale.to(F32), best_min.to(F32), best_q


def _quant_k_affine(x: torch.Tensor, nmax: int, k: _Consts, w: Optional[torch.Tensor] = None):
    """The Q4_K / Q5_K super-block (JAX :395-424): eight groups of 32 fitted
    by the grid search, their scales and mins quantized to 6 bits under f16
    super-scales, then every element re-quantized with the decoded scales.
    ``x`` [n, 256] → ``(d, dmin [n, 1] f32, sc6, mn6 [n, 8], q [n, 256])``
    (codes as floats)."""
    n = x.shape[0]
    scales, mins, _ = _make_qkx2_quants(x.reshape(n * 8, 32), nmax, k,
                                        None if w is None else w.reshape(n * 8, 32))
    scales, mins = scales.reshape(n, 8), mins.reshape(n, 8)
    max_scale = scales.amax(dim=1, keepdim=True)
    max_min = mins.amax(dim=1, keepdim=True)
    sixty3 = k(63.0)
    inv_scale = torch.where(max_scale > 0, sixty3 / torch.where(max_scale > 0, max_scale, k(1.0)),
                            k(0.0))
    inv_min = torch.where(max_min > 0, sixty3 / torch.where(max_min > 0, max_min, k(1.0)), k(0.0))
    sc6 = _clip_int(inv_scale * scales, 0, 63)
    mn6 = _clip_int(inv_min * mins, 0, 63)
    d = (max_scale / sixty3).to(torch.float16).to(F32)
    dmin = (max_min / sixty3).to(torch.float16).to(F32)
    es = (d * sc6).repeat_interleave(32, dim=1)
    em = (dmin * mn6).repeat_interleave(32, dim=1)
    q = _clip_int((x + em) * _safe_inv(es, k), 0, nmax)
    return d, dmin, _u8(sc6), _u8(mn6), _u8(q)


def _quant_q4_k(x: torch.Tensor, k: _Consts, w=None) -> torch.Tensor:
    d, dmin, sc6, mn6, q = _quant_k_affine(x, 15, k, w)
    return torch.cat([_f16_bytes(d), _f16_bytes(dmin), _pack_scale_min_k4(sc6, mn6),
                      _pack_q4k_nibbles(q)], dim=1)


def _quant_q5_k(x: torch.Tensor, k: _Consts, w=None) -> torch.Tensor:
    d, dmin, sc6, mn6, q = _quant_k_affine(x, 31, k, w)
    # high bit of element l → bit l // 32 of qh byte l % 32
    shifts = torch.arange(8, device=x.device, dtype=torch.uint8)[None, :, None]
    qh = ((q >> 4).reshape(-1, 8, 32) << shifts).sum(1, dtype=torch.int32).to(torch.uint8)
    return torch.cat([_f16_bytes(d), _f16_bytes(dmin), _pack_scale_min_k4(sc6, mn6), qh,
                      _pack_q4k_nibbles(q & 15)], dim=1)


def _quant_q6_k(x: torch.Tensor, k: _Consts) -> torch.Tensor:
    """Q6_K (JAX :471-506): per group of 16 a signed scale, extreme / -32,
    refined once by least squares; the 16 scales to int8 under an f16
    super-scale; codes in [-32, 31] stored biased by 32."""
    n = x.shape[0]
    groups = x.reshape(n, 16, 16)
    idx = groups.abs().argmax(dim=2, keepdim=True)
    s = groups.gather(2, idx)[:, :, 0] / k(-32.0)
    q = _clip_int(groups * _safe_inv(s, k, positive=False)[:, :, None], -32, 31).to(F64)
    num = _pairwise((q * groups.to(F64)).reshape(n * 16, 16)).reshape(n, 16)
    den = (q * q).sum(dim=2)
    one64 = k(1.0, F64)
    s = torch.where(den > 0, num / torch.where(den > 0, den, one64), s.to(F64)).to(F32)
    max_abs = s.abs().amax(dim=1, keepdim=True)
    d = (max_abs / k(127.0)).to(torch.float16).to(F32)
    sc8 = _clip_int(s * _safe_inv(d, k), -128, 127)
    es = (d * sc8).repeat_interleave(16, dim=1)
    q6 = _u8(_clip_int(x * _safe_inv(es, k, positive=False), -32, 31) + 32)
    return torch.cat([_pack_q6k_codes(q6), sc8.to(torch.int8).view(torch.uint8),
                      _f16_bytes(d)], dim=1)


def _pack_2bit(q: torch.Tensor) -> torch.Tensor:
    """[n, 256] 2-bit codes → the 64 ``qs`` bytes of Q2_K / Q3_K: element
    128 h + 32 s + j at bits 2 s of byte 32 h + j."""
    q = q.reshape(-1, 2, 4, 32)
    return (q[:, :, 0] | (q[:, :, 1] << 2) | (q[:, :, 2] << 4) | (q[:, :, 3] << 6)).reshape(-1, 64)


def _quant_q2_k(x: torch.Tensor, k: _Consts) -> torch.Tensor:
    """Q2_K (JAX :528-560): sixteen groups of 16 fitted by the grid search
    (codes 0..3), their scales and mins to 4 bits under f16 super-scales,
    then every element re-quantized with the decoded scales (84 B / 256)."""
    n = x.shape[0]
    scales, mins, _ = _make_qkx2_quants(x.reshape(n * 16, 16), 3, k)
    scales, mins = scales.reshape(n, 16), mins.reshape(n, 16)
    max_scale = scales.amax(dim=1, keepdim=True)
    max_min = mins.amax(dim=1, keepdim=True)
    fifteen = k(15.0)
    inv_scale = torch.where(max_scale > 0, fifteen / torch.where(max_scale > 0, max_scale,
                                                                  k(1.0)), k(0.0))
    inv_min = torch.where(max_min > 0, fifteen / torch.where(max_min > 0, max_min, k(1.0)),
                          k(0.0))
    sc4 = _clip_int(inv_scale * scales, 0, 15)
    mn4 = _clip_int(inv_min * mins, 0, 15)
    d = (max_scale / fifteen).to(torch.float16).to(F32)
    dmin = (max_min / fifteen).to(torch.float16).to(F32)
    es = (d * sc4).repeat_interleave(16, dim=1)
    em = (dmin * mn4).repeat_interleave(16, dim=1)
    q = _u8(_clip_int((x + em) * _safe_inv(es, k), 0, 3))
    return torch.cat([_u8(sc4) | (_u8(mn4) << 4), _pack_2bit(q), _f16_bytes(d),
                      _f16_bytes(dmin)], dim=1)


def _quant_q3_k(x: torch.Tensor, k: _Consts) -> torch.Tensor:
    """Q3_K (JAX :563-608): per group of 16 a symmetric scale (the amax
    seed, one least-squares refit), the 16 scales to signed 6 bits under an
    f16 super-scale, codes in [-4, 3] stored biased by 4 as 2 low bits and
    a high-bit mask (110 B / 256)."""
    n = x.shape[0]
    groups = x.reshape(n * 16, 16)
    amax = groups.abs().amax(dim=1, keepdim=True)
    s0 = torch.where(amax > 0, amax / k(4.0), k(1.0))
    q0 = _clip_int(groups / s0, -4, 3)
    num = _pairwise(groups * q0)
    den = _pairwise(q0 * q0)
    s1 = torch.where(den > 0, num / torch.where(den > 0, den, k(1.0)), s0[:, 0])
    scales = s1.reshape(n, 16)
    max_abs = scales.abs().amax(dim=1, keepdim=True)
    thirty1 = k(31.0)
    inv = torch.where(max_abs > 0, thirty1 / torch.where(max_abs > 0, max_abs, k(1.0)), k(0.0))
    sc6 = _clip_int(inv * scales, -32, 31)
    d = (max_abs / thirty1).to(torch.float16).to(F32)
    es = (d * sc6).repeat_interleave(16, dim=1)
    q = (_clip_int(x * _safe_inv(es, k, positive=False), -4, 3) + 4).to(torch.int32)
    hm = ((q >> 2) & 1).to(torch.uint8).reshape(-1, 8, 32)
    shifts = torch.arange(8, device=x.device, dtype=torch.uint8)[None, :, None]
    hmask = (hm << shifts).sum(1, dtype=torch.int32).to(torch.uint8)
    sp = (sc6 + 32).to(torch.int32).to(torch.uint8)  # the signed scales stored as value + 32
    lo, hi = sp & 15, (sp >> 4) & 3
    scales12 = torch.cat([lo[:, :8] | (lo[:, 8:] << 4),
                          (hi.reshape(n, 4, 4) << (2 * shifts[0, :4])).sum(1, dtype=torch.int32)
                          .to(torch.uint8)], dim=1)
    return torch.cat([hmask, _pack_2bit((q & 3).to(torch.uint8)), scales12, _f16_bytes(d)],
                     dim=1)


_QUANTIZERS = {
    GGMLType.Q2_K: _quant_q2_k,
    GGMLType.Q3_K: _quant_q3_k,
    GGMLType.Q8_0: _quant_q8_0,
    GGMLType.Q4_0: _quant_q4_0,
    GGMLType.Q5_0: _quant_q5_0,
    GGMLType.Q4_K: _quant_q4_k,
    GGMLType.Q5_K: _quant_q5_k,
    GGMLType.Q6_K: _quant_q6_k,
}
# the types that refit with importance weights (the others ignore them)
_WEIGHTED = (GGMLType.Q4_K, GGMLType.Q5_K)

QUANT_TYPES = frozenset(_QUANTIZERS)  # the types quantize() writes


def quantize(x: torch.Tensor, t: GGMLType,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize ``x`` (any float dtype; blocks along its last axis, whose
    length must be a whole number of blocks) to type ``t``'s raw GGUF
    bytes: flat ``uint8`` on ``x``'s device, in row-major block order,
    equal to JAX ``quants.quantize(x, t)``.

    ``weights``: importance weights, a vector over the last axis (an
    imatrix row: mean squared activations) or a tensor of ``x``'s shape;
    floored at 1e-10, and used by Q4_K and Q5_K only, as JAX
    ``quantize_imatrix`` does. Rows are quantized in chunks of about
    :data:`CHUNK_WEIGHTS` weights."""
    fn = _QUANTIZERS.get(t)
    if fn is None:
        raise NotImplementedError(f"quantization to {t!r}: not a type this module writes "
                                  f"({sorted(q.name for q in QUANT_TYPES)})")
    tr = type_traits(t)
    cols = x.shape[-1] if x.dim() else 1
    if cols % tr.block_size:
        raise ValueError(f"{tuple(x.shape)}: the last axis is not whole blocks of {tr.block_size}")
    x2 = x.reshape(-1, cols)
    w2 = None
    if weights is not None and t in _WEIGHTED:
        w2 = weights.to(device=x.device, dtype=F32).expand(x.shape).reshape(-1, cols)
    k = _Consts(x.device)
    rows = max(1, CHUNK_WEIGHTS // cols)
    per_row = cols // tr.block_size
    out = torch.empty((x2.shape[0] * per_row, tr.type_size), dtype=torch.uint8, device=x.device)
    for r0 in range(0, x2.shape[0], rows):
        xc = x2[r0:r0 + rows].to(F32).reshape(-1, tr.block_size)
        blocks = slice(r0 * per_row, r0 * per_row + xc.shape[0])
        if w2 is None:
            out[blocks] = fn(xc, k)
        else:
            wc = w2[r0:r0 + rows].clamp(min=1e-10).reshape(-1, tr.block_size)
            out[blocks] = fn(xc, k, wc)
    return out.reshape(-1)


__all__ = ["CHUNK_WEIGHTS", "QUANT_TYPES", "quantize"]
