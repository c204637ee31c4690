"""Random GGUF checkpoints drawn on a device, read through the GGUF loader.

A full-width quantized checkpoint (Qwen3-30B-A3B in a Q2_K mix is about 12
GB of raw blocks) need not exist as a file for the loader to be driven at
full size: :class:`DrawnGGUF` has the loader's content interface
(``metadata``, ``tensor_info``, ``tensor_bytes``, ``in``) and draws each
tensor's raw blocks on the device, from a generator of that tensor's own
seed, when the loader reads it, so no tensor is held beside the planes
decoded from it. :func:`draw_blocks` makes the blocks of every planar type
of ``planar.py``; :func:`llama_family_tensors` and :func:`gguf_metadata`
lay out a llama-family checkpoint (``llama``, ``qwen2``, ``qwen3``,
``qwen3moe``) of a :class:`ModelConfig` in a mix of types.

The drawn weights centre on zero and have an rms of ``std`` (by default
``1 / sqrt(K)``, so activations keep their scale through a layer): each
type's codes and "min" biases are drawn so that a group's weights have mean
zero. Codes whose mean is half a step off zero give every weight of a
matrix a common part that a product of K inputs amplifies ~sqrt(K) times
over the noise, which lifts activations layer by layer; for the types
whose bias is fixed by the format (Q3_K, Q4_0, Q5_0, Q6_K, Q8_0) the codes
are drawn from a range symmetric about the format's zero, for those with a
free bias (Q2_K, Q4_1, Q4_K, Q5_1, Q5_K) the bias is the codes' mean times
the scale, exactly: each block's f16 scale ``d`` has 6 significant bits, so
``1.5 d``, ``7.5 d`` and ``15.5 d`` are f16 values too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..models.config import ModelConfig
from .constants import GGMLType, type_traits
from .quants import (
    _f16_bytes,
    _pack_bits,
    _pack_nibbles,
    _pack_q6k_codes,
    _pack_scale_min_k4,
)

# (sub-scale range, code range) of each type's draw; the codes as the format
# stores them (unsigned), the sub-scales as integers
_CODES = {
    GGMLType.Q4_0: (None, (1, 15)), GGMLType.Q4_1: (None, (0, 15)),
    GGMLType.Q5_0: (None, (1, 31)), GGMLType.Q5_1: (None, (0, 31)),
    GGMLType.Q8_0: (None, (-127, 127)), GGMLType.Q2_K: ((1, 15), (0, 3)),
    GGMLType.Q3_K: ((8, 31), (1, 7)), GGMLType.Q4_K: ((1, 63), (0, 15)),
    GGMLType.Q5_K: ((1, 63), (0, 31)), GGMLType.Q6_K: ((16, 63), (1, 63)),
}


def _mean_sq(lo: int, hi: int) -> float:
    """E[s^2] for s uniform over the integers lo..hi."""
    return sum(s * s for s in range(lo, hi + 1)) / (hi - lo + 1)


def _var(lo: int, hi: int) -> float:
    """The variance of the integers lo..hi, uniform."""
    return ((hi - lo + 1) ** 2 - 1) / 12


def _ints(lo, hi, shape, gen, dev, dtype=torch.uint8):
    return torch.randint(lo, hi + 1, shape, generator=gen, device=dev,
                         dtype=torch.int32).to(dtype)


def _d6(n: int, d0: float, gen, dev) -> torch.Tensor:
    """n block scales around ``d0`` (x 0.75..1.25) as f16 values with 6
    significant bits (the low 5 mantissa bits cleared), widened to f32."""
    d = (d0 * (0.75 + 0.5 * torch.rand(n, generator=gen, device=dev))).to(torch.float16)
    return (d.view(torch.int16) & ~0x1F).view(torch.float16).to(torch.float32)


def _pack_q3k_scales(raw6: torch.Tensor) -> torch.Tensor:
    """[n, 16] 6-bit scales (stored as value + 32) → the 12 packed bytes."""
    lo = raw6 & 15
    hi = raw6 >> 4
    out = [lo[:, g] | (lo[:, g + 8] << 4) for g in range(8)]
    out += [hi[:, i] | (hi[:, i + 4] << 2) | (hi[:, i + 8] << 4) | (hi[:, i + 12] << 6)
            for i in range(4)]
    return torch.stack(out, dim=1)


def draw_blocks(t: GGMLType, shape: tuple[int, ...], gen: torch.Generator, device,
                std: Optional[float] = None) -> torch.Tensor:
    """Raw GGUF blocks of type ``t`` for a tensor of ``shape`` (blocks along
    the last axis), drawn on ``device``: weights centred on zero with an rms
    of ``std`` (default ``1 / sqrt(shape[-1])``). Returns flat ``uint8``."""
    tr = type_traits(t)
    numel = math.prod(shape)
    if numel % tr.block_size:
        raise ValueError(f"{shape}: not whole blocks of {tr.block_size}")
    n = numel // tr.block_size
    std = shape[-1] ** -0.5 if std is None else std
    sub, (clo, chi) = _CODES[t]
    centre = {GGMLType.Q4_0: 8, GGMLType.Q5_0: 16, GGMLType.Q8_0: 0, GGMLType.Q3_K: 4,
              GGMLType.Q6_K: 32}.get(t, (clo + chi) / 2)
    spread = _var(clo, chi) + (0 if t in (GGMLType.Q2_K, GGMLType.Q4_1, GGMLType.Q4_K,
                                           GGMLType.Q5_1, GGMLType.Q5_K)
                               else ((clo + chi) / 2 - centre) ** 2)
    d = _d6(n, std / math.sqrt(spread * (_mean_sq(*sub) if sub else 1.0)), gen, device)
    dev = device
    if t == GGMLType.Q8_0:
        parts = [_f16_bytes(d), _ints(clo, chi, (n, 32), gen, dev, torch.int8).view(torch.uint8)]
    elif t in (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1):
        codes = _ints(clo, chi, (n, 32), gen, dev)
        parts = [_f16_bytes(d)]
        if t in (GGMLType.Q4_1, GGMLType.Q5_1):  # m = -centre d, exact
            parts.append(_f16_bytes(-centre * d))
        if t in (GGMLType.Q5_0, GGMLType.Q5_1):
            parts.append(_pack_bits(codes >> 4))
        parts.append(_pack_nibbles(codes & 15))
    elif t == GGMLType.Q2_K:  # codes of random bytes, mins = scales, dmin = 1.5 d
        sc = _ints(*sub, (n, 16), gen, dev)
        parts = [sc | (sc << 4), _ints(0, 255, (n, 64), gen, dev), _f16_bytes(d),
                 _f16_bytes(1.5 * d)]
    elif t == GGMLType.Q3_K:  # codes 1..7 (-3..3 about the format's 4)
        codes = _ints(clo, chi, (n, 2, 4, 32), gen, dev)  # element half*128 + quarter*32 + pos
        qs = sum((codes[:, :, q] & 3) << (2 * q) for q in range(4)).reshape(n, 64)
        hi = (codes >> 2).reshape(n, 8, 32)  # element j*32 + pos → bit j of hmask byte pos
        hmask = sum(hi[:, j] << j for j in range(8))
        raw6 = _ints(sub[0] + 32, sub[1] + 32, (n, 16), gen, dev)
        parts = [hmask, qs, _pack_q3k_scales(raw6), _f16_bytes(d)]
    elif t in (GGMLType.Q4_K, GGMLType.Q5_K):  # codes of random bytes, mn = sc
        sc = _ints(*sub, (n, 8), gen, dev)
        parts = [_f16_bytes(d), _f16_bytes(centre * d), _pack_scale_min_k4(sc, sc)]
        if t == GGMLType.Q5_K:
            parts.append(_ints(0, 255, (n, 32), gen, dev))
        parts.append(_ints(0, 255, (n, 128), gen, dev))
    elif t == GGMLType.Q6_K:  # codes 1..63 (-31..31 about the format's 32)
        parts = [_pack_q6k_codes(_ints(clo, chi, (n, 256), gen, dev)),
                 _ints(*sub, (n, 16), gen, dev, torch.int8).view(torch.uint8), _f16_bytes(d)]
    else:
        raise NotImplementedError(f"no block draw for {t!r}")
    out = torch.cat([p.to(torch.uint8) for p in parts], dim=1)
    assert out.shape[1] == tr.type_size, (t, out.shape)
    return out.reshape(-1)


@dataclass
class DrawnTensor:
    """One tensor of a drawn checkpoint: its logical shape and GGML type,
    and for a dense (F32) tensor its values: ``fill`` plus N(0, std^2)."""

    shape: tuple[int, ...]
    ggml_type: GGMLType
    std: Optional[float] = None
    fill: float = 0.0


class DrawnGGUF:
    """A GGUF checkpoint (``metadata`` and ``tensors``) whose raw blocks are
    drawn on ``device`` as the loader reads them (module docstring): tensor
    ``i`` from a generator of seed ``seed + 7919 (i + 1)``."""

    def __init__(self, metadata: dict, tensors: dict[str, DrawnTensor], device, seed: int = 0):
        self.metadata = metadata
        self.tensors = tensors
        self.device = torch.device(device)
        self._seeds = {name: seed + 7919 * (i + 1) for i, name in enumerate(tensors)}

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def tensor_info(self, name: str) -> DrawnTensor:
        return self.tensors[name]

    def tensor_bytes(self, name: str, device=None) -> torch.Tensor:
        """The tensor's raw blocks, drawn on this content's device (then
        moved to ``device`` where another is asked for)."""
        t = self.tensors[name]
        gen = torch.Generator(device=self.device).manual_seed(self._seeds[name])
        if t.ggml_type == GGMLType.F32:
            v = torch.randn(t.shape, generator=gen, device=self.device) * (t.std or 0.0)
            raw = (v + t.fill).contiguous().view(torch.uint8).reshape(-1)
        else:
            raw = draw_blocks(t.ggml_type, t.shape, gen, self.device, t.std)
        return raw if device is None else raw.to(device)

    def nbytes(self) -> int:
        """The raw bytes of all its tensors (as a file would hold them)."""
        return sum(math.prod(t.shape) // type_traits(t.ggml_type).block_size
                   * type_traits(t.ggml_type).type_size for t in self.tensors.values())

    def close(self) -> None:
        pass


def gguf_metadata(cfg: ModelConfig) -> dict:
    """The ``<arch>.*`` keys that ``config_from_gguf`` reads, for ``cfg``."""
    a = cfg.arch
    md = {"general.architecture": a, f"{a}.block_count": cfg.num_layers,
          f"{a}.context_length": cfg.max_position_embeddings,
          f"{a}.embedding_length": cfg.hidden_size,
          f"{a}.feed_forward_length": cfg.intermediate_size,
          f"{a}.attention.head_count": cfg.num_heads,
          f"{a}.attention.head_count_kv": cfg.num_kv_heads,
          f"{a}.attention.key_length": cfg.head_dim,
          f"{a}.attention.layer_norm_rms_epsilon": cfg.rms_norm_eps,
          f"{a}.rope.freq_base": cfg.rope_theta, f"{a}.vocab_size": cfg.vocab_size}
    if cfg.num_experts:
        md.update({f"{a}.expert_count": cfg.num_experts,
                   f"{a}.expert_used_count": cfg.num_experts_per_tok,
                   f"{a}.expert_feed_forward_length": cfg.moe_intermediate_size})
    return md


def llama_family_tensors(cfg: ModelConfig,
                         type_of: Callable[[str, Optional[int]], GGMLType]) -> dict:
    """The tensors of a llama-family GGUF of ``cfg`` (llama.cpp's names and
    ``[out, in]`` shapes), each projection in ``type_of(stem, layer)``'s
    type (``stem``: ``token_embd``, ``output``, ``attn_q`` ... or
    ``ffn_gate_exps`` ...; ``layer`` None for the first two): F32 norms of
    ones, qwen2's q/k/v biases N(0, 0.1^2), q/k norms 1 + N(0, 0.1^2), an
    F32 router N(0, 1/H); no ``output`` when the head is tied."""
    h, v = cfg.hidden_size, cfg.vocab_size
    f32 = GGMLType.F32
    out = {"token_embd.weight": DrawnTensor((v, h), type_of("token_embd", None)),
           "output_norm.weight": DrawnTensor((h,), f32, fill=1.0)}
    if not cfg.tie_word_embeddings:
        out["output.weight"] = DrawnTensor((v, h), type_of("output", None))
    for i in range(cfg.num_layers):
        p = f"blk.{i}."
        projs = {"attn_q": (cfg.q_dim, h), "attn_k": (cfg.kv_dim, h),
                 "attn_v": (cfg.kv_dim, h), "attn_output": (h, cfg.q_dim)}
        if cfg.num_experts:
            e, mi = cfg.num_experts, cfg.moe_intermediate_size
            projs.update({"ffn_gate_exps": (e, mi, h), "ffn_up_exps": (e, mi, h),
                          "ffn_down_exps": (e, h, mi)})
        else:
            i_ = cfg.intermediate_size
            projs.update({"ffn_gate": (i_, h), "ffn_up": (i_, h), "ffn_down": (h, i_)})
        out[p + "attn_norm.weight"] = DrawnTensor((h,), f32, fill=1.0)
        out[p + "ffn_norm.weight"] = DrawnTensor((h,), f32, fill=1.0)
        for stem, shape in projs.items():
            out[p + stem + ".weight"] = DrawnTensor(shape, type_of(stem, i))
        if cfg.arch == "qwen2":
            for t, n in (("q", cfg.q_dim), ("k", cfg.kv_dim), ("v", cfg.kv_dim)):
                out[p + f"attn_{t}.bias"] = DrawnTensor((n,), f32, std=0.1)
        if cfg.qk_norm:
            for t in "qk":
                out[p + f"attn_{t}_norm.weight"] = DrawnTensor((cfg.head_dim,), f32, std=0.1,
                                                               fill=1.0)
        if cfg.num_experts:
            out[p + "ffn_gate_inp.weight"] = DrawnTensor((cfg.num_experts, h), f32, std=h ** -0.5)
    return out


__all__ = ["DrawnGGUF", "DrawnTensor", "draw_blocks", "gguf_metadata", "llama_family_tensors"]
