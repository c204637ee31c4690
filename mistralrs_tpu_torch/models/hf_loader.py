"""Hugging Face checkpoints (counterpart of
``mistralrs_tpu/models/hf_loader.py``): a safetensors reader with its own
parser (the ``safetensors`` package is not needed), and the llama-family
loader (``weights_from_state_dict``, ``load_hf_model``) for dense
checkpoints.

A ``.safetensors`` file is an 8-byte little-endian header length, a JSON
header ``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}``
(plus an optional ``__metadata__`` entry), then the raw little-endian data,
offsets counted from the end of the header. A directory holds one file or
the shards named by ``model.safetensors.index.json``; its tensors are read
from their files as the loader looks them up (:class:`SafetensorsDir`), so
the host holds one tensor at a time. ``write_safetensors`` writes the
``safetensors`` package's bytes.

The loader takes dense bf16, f16 or f32 tensors: the attention and MLP
projections, the norms (Gemma-2's pre- and post-norms through the JAX
package's ``_GEMMA_LAYER_MAP``; Qwen3's per-head ``q_norm``/``k_norm``),
Mixtral's router and expert banks, Qwen3-MoE's and Qwen1.5-MoE's
(qwen2moe) router (``mlp.gate``) and expert banks
(``mlp.experts.N.{gate,up,down}_proj``, stacked as Mixtral's: ``gate``,
``up`` [E, I, H], ``down`` [E, H, I]; ``fuse_projections`` fuses gate and
up into one ``gateup`` bank for the grouped kernels), qwen2moe's shared
expert (``mlp.shared_expert.{gate,up,down}_proj`` into the layer's
``shared_expert`` dict, JAX ``hf_loader.py:335-340``) and its gate
(``mlp.shared_expert_gate``, ``[1, H]``), the embedding, and the head
(tied to the embedding when the checkpoint has no ``lm_head.weight``, as
the JAX loader does whatever ``tie_word_embeddings`` says); the q/k/v/o biases wherever the checkpoint has them (JAX
``hf_loader.py:56-59`` maps them by name: a Qwen2 ``config.json`` has no
``attention_bias`` key, yet its q/k/v carry biases); and gpt-oss's sinks, router bias and expert banks (JAX ``hf_loader.py:98-104``,
:342-349), dense or in MXFP4 (``quantization_config.quant_method ==
"mxfp4"``: ``<stem>_blocks``/``_scales`` uint8, stored transposed,
``[E, out, in / 32, 16]``, decoded on the device by ``quant/mxfp4.py``).
The Llama-family variants' tensors (JAX ``_HF_LAYER_MAP``'s remaining
entries): the LayerNorm biases (``input_layernorm.bias``,
``post_attention_layernorm.bias``; the final ``norm`` or phi2's
``final_layernorm``, weight and bias), starcoder2's gateless
``mlp.c_fc``/``c_proj`` and phi2's ``mlp.fc1``/``fc2`` and
``self_attn.dense`` with their biases, glm4's ``post_self_attn_layernorm``
and ``post_mlp_layernorm``, hunyuan's ``query_layernorm`` and
``key_layernorm``, phi2's ``lm_head.bias``, and phi3's fused
``self_attn.qkv_proj`` and ``mlp.gate_up_proj`` (glm's too), split at load
into q/k/v and gate/up (JAX ``_PHI3_FUSED``), each part read, cast or
quantized in situ as its own tensor.
gpt-oss's banks are stored as the dense grouped kernel reads them:
K-contiguous ``[E, N, K]``, the gate-up bank's interleaved columns (gate
even, up odd) as a gate half then an up half, its bias permuted alike (a
permutation: no value changes). GPTQ and AWQ checkpoints
(``quantization_config.quant_method`` ``"gptq"`` or ``"awq"``, JAX
``hf_loader.py:184-216``) store a projection ``<stem>.weight`` as the int32
``<stem>.qweight``/``qzeros`` and f16 ``<stem>.scales`` (GPTQ: and
``g_idx``), decoded on the device by ``quant/gptq_awq.py`` into planar
QTensors for the W4 and W8 kernels (v1 GPTQ zeros take the offset 1,
``checkpoint_format`` ``"gptq_v2"`` none); their f16 embedding and head are
cast to ``dtype``. Mixtral's, Qwen3-MoE's and qwen2moe's experts are
decoded one by one as they are read (the int32 words of one expert on the
device at a time) and stacked into a bank (``QTensor.stack``: JAX
``build_stacked``, :272-273, stacks them alike); the grouped W4 and W8
kernels take them at groups 64 and 128. Their routers and qwen2moe's
shared-expert gate stay dense, as AutoGPTQ and AutoAWQ leave them.
bitsandbytes 4-bit checkpoints (``quant_method`` ``"bitsandbytes"``, JAX
``hf_loader.py:190-200``: NF4 or FP4 codes with their ``absmax``,
``quant_map``, nested scales and ``quant_state`` side tensors) decode on the
device (``quant/bnb.py``) into dense weights, which are then cast or
quantized in situ like any dense tensor.
Everything else raises ``NotImplementedError`` naming it: bitsandbytes
8-bit, MXFP4 outside gpt-oss, GPTQ/AWQ at other than 4 or 8 bits (AWQ: 4 only),
AWQ packings other than ``"gemm"``, GPTQ act-order (a non-trivial
``g_idx``, which the JAX package refuses too; an expert's as well),
GPTQ/AWQ on gpt-oss's pre-stacked banks or on any other MoE arch, a
router, shared-expert gate or ``lm_head`` stored as GPTQ/AWQ words, fused
projections stored as GPTQ/AWQ words, the biases of a gated MLP
(``mlp.{gate,up,down}_proj.bias``, which the JAX loader drops), per-head
q/k LayerNorms (stablelm's and phi's ``q_layernorm``/``k_layernorm``), and
expert banks other than Mixtral's,
Qwen3-MoE's, qwen2moe's and gpt-oss's.

A topology (``topology.py``, with ``isq``) gives each layer's quantized
tensors its own type (JAX ``hf_loader.py:276-290``): the layers keep their
own types, so they need no widening to a common form. ``from_uqff`` (JAX
``load_hf_model``, :427-445) overlays a mistral.rs UQFF file
(``uqff.py::load_reference_uqff``): its layers, already quantized and
decoded into planes on the device, or plain, replace the checkpoint's
tensors of the same names.

In-situ quantization (ISQ, JAX ``hf_loader.py:121-155``): with ``isq`` (a
GGUF type of ``gguf/quants.py``: Q4_K, Q5_K, Q6_K, Q8_0, Q4_0, Q5_0) every
dense tensor the plan names (:func:`default_isq_plan`: 2-D, not a norm or
a bias, K a multiple of 256; ``embed_tokens`` and ``lm_head`` at Q8_0,
the rest at ``isq``) is quantized to GGUF blocks as it is read, on
``device``, from its checkpoint dtype (f32 there), and the blocks decoded
into planes (``gguf/planar.py::to_planar``, ``QTensor.from_planar``): the
JAX package's bytes and planes, bit for bit. The plan sees JAX's names
(``layers.<key>`` with qwen2moe's shared expert as ``se_gate``/``se_up``/
``se_down``, ``layers.exp_gate``/``exp_up``/``exp_down`` for each expert,
``embed_tokens``, ``lm_head``). A tensor the plan leaves alone stays dense
(qwen2moe's expert down bank at K = 1408 runs on the dense grouped
kernel beside quantized gate/up banks); one already quantized (GPTQ, AWQ)
stays as it is. A quantized matrix whose N is not a multiple of 16 (a
router of 8 or 60 experts, the shared-expert gate) is zero-padded to one
(``QTensor.pad_rows``) so that the W4/W8 kernels take it. ``imatrix``
(``imatrix.py``'s taps) gives Q4_K and Q5_K each layer's importance row,
``rows[i % len(rows)]`` as JAX ``build_stacked`` indexes them; the other
types ignore it.
"""

from __future__ import annotations

import collections.abc
import json
import os
import re
import struct
from pathlib import Path
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from .._device import IO_CHUNK, DeviceLike, read_bytes, resolve_device
from ..gguf.constants import GGMLType
from ..gguf.planar import to_planar
from ..gguf.quants import quantize
from ..imatrix import imatrix_rows_for_key
from ..quant.bnb import decode_bnb_param, side_tensor_names
from ..quant.gptq_awq import awq_to_qtensor, gptq_to_qtensor
from ..quant.mxfp4 import decode_mxfp4_param
from ..quant.qtensor import QTensor
from .config import ModelConfig, config_from_hf
from .llama import check_supported

# safetensors dtype names, in the format's own order (its writer lays the
# tensors out by this rank, largest first, then by name)
_DTYPES = {"BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
           "F8_E4M3": torch.float8_e4m3fn, "I16": torch.int16, "U16": torch.uint16,
           "F16": torch.float16, "BF16": torch.bfloat16, "I32": torch.int32,
           "U32": torch.uint32, "F32": torch.float32, "F64": torch.float64,
           "I64": torch.int64}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}
_DTYPE_RANK = {name: i for i, name in enumerate(_DTYPES)}


class SafetensorsFile:
    """One ``.safetensors`` file: ``header`` (name → dtype, shape, offsets),
    ``metadata`` (the ``__metadata__`` strings) and :meth:`get`, which reads
    one tensor from the file into a CPU tensor in its own dtype (the names
    of ``_DTYPES``; others raise). Nothing is mapped or kept: only the
    tensor asked for is in host memory, and only while its caller holds it."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self._data_start = 8 + n
        self.metadata = header.pop("__metadata__", None) or {}
        self.header = header

    def keys(self):
        return self.header.keys()

    def get(self, name: str, device: DeviceLike = "cpu") -> torch.Tensor:
        """``name``'s tensor on ``device``: a CPU tensor by default; on a
        card it is copied there in chunks of :data:`IO_CHUNK` bytes, so the
        host holds one chunk, not the tensor."""
        info = self.header[name]
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise NotImplementedError(f"{self.path.name}: {name} has dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        out = read_bytes(self.path, self._data_start + begin, end - begin, device, name)
        return out.view(dtype).reshape(info["shape"])


class SafetensorsDir(collections.abc.MutableMapping):
    """The tensors of a model directory's safetensors files as a mapping
    that reads each tensor from its file onto ``device`` when it is looked
    up (not kept), so a loader holds at most one tensor on the host, or one
    chunk of it when ``device`` is a card. Assigned entries (a UQFF
    overlay's) take the place of the files' tensors of those names."""

    def __init__(self, files, device: DeviceLike = "cpu"):
        self._device = device
        self._where: dict[str, SafetensorsFile] = {}
        self._set: dict[str, Any] = {}
        for f in files:
            st = SafetensorsFile(f)
            self._where.update(dict.fromkeys(st.keys(), st))

    def __getitem__(self, name):
        if name in self._set:
            return self._set[name]
        return self._where[name].get(name, self._device)

    def __setitem__(self, name, value):
        self._set[name] = value

    def __delitem__(self, name):
        self._set.pop(name, None)
        self._where.pop(name)

    def __contains__(self, name):
        return name in self._set or name in self._where

    def __iter__(self):
        yield from self._where
        yield from (k for k in self._set if k not in self._where)

    def __len__(self):
        return len(self._where) + sum(k not in self._where for k in self._set)


def load_safetensors_dir(path: str | os.PathLike, device: DeviceLike = "cpu") -> SafetensorsDir:
    """All tensors of a model directory, read onto ``device`` as they are
    looked up (:class:`SafetensorsDir`): the shards of
    ``model.safetensors.index.json`` where it exists, else every
    ``*.safetensors`` file."""
    path = Path(path)
    index = path / "model.safetensors.index.json"
    if index.exists():
        files = sorted(set(json.loads(index.read_text())["weight_map"].values()))
        files = [path / f for f in files]
    else:
        files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files in {path}")
    return SafetensorsDir(files, device)


def write_bytes(f, t: torch.Tensor) -> int:
    """Write ``t``'s bytes to the open file ``f`` (a tensor on a card is
    copied to the host in chunks of :data:`IO_CHUNK` bytes); returns their
    count."""
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    for lo in range(0, flat.numel(), IO_CHUNK):
        f.write(flat[lo:lo + IO_CHUNK].cpu().numpy().data)
    return flat.numel()


def write_safetensors(path: str | os.PathLike, tensors: Mapping[str, Any],
                      metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (name → a tensor on any device, or a list of
    tensors of one shape and dtype, written as their stack along a new
    first axis) as the ``safetensors`` package's ``save_file`` writes them,
    byte for byte: the tensors ordered by dtype (the format's rank, largest
    first) then name, the compact JSON header (``__metadata__`` first) padded
    with spaces to 8 bytes. The data is streamed: one tensor (one part of a
    list) is copied to the host at a time."""
    entries = []
    for name, t in tensors.items():
        parts = list(t) if isinstance(t, (list, tuple)) else [t]
        first = parts[0]
        shape = [len(parts), *first.shape] if isinstance(t, (list, tuple)) else list(first.shape)
        code = _DTYPE_NAMES[first.dtype]
        nbytes = sum(p.numel() * p.element_size() for p in parts)
        entries.append((_DTYPE_RANK[code], name, code, shape, parts, nbytes))
    entries.sort(key=lambda e: (-e[0], e[1]))
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    off = 0
    for _, name, code, shape, _, nbytes in entries:
        header[name] = {"dtype": code, "shape": shape, "data_offsets": [off, off + nbytes]}
        off += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for *_, parts, _ in entries:
            for p in parts:
                write_bytes(f, p)


# HF tensor names of a llama-family layer → the port's layer keys (the
# dense entries of JAX hf_loader.py's _HF_LAYER_MAP, :50-105)
_HF_LAYER_MAP = {
    "input_layernorm.weight": "attn_norm",
    "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo",
    "post_attention_layernorm.weight": "ffn_norm",
    "mlp.gate_proj.weight": "gate",
    "mlp.up_proj.weight": "up",
    "mlp.down_proj.weight": "down",
    "pre_feedforward_layernorm.weight": "ffn_norm",  # gemma2/3
    "post_feedforward_layernorm.weight": "post_ffn_norm",
    "block_sparse_moe.gate.weight": "router",  # mixtral
    "mlp.c_fc.weight": "up",  # starcoder2's gateless MLP
    "mlp.c_proj.weight": "down",
    "mlp.c_fc.bias": "up_bias",
    "mlp.c_proj.bias": "down_bias",
    "input_layernorm.bias": "attn_norm_bias",  # LayerNorm archs
    "post_attention_layernorm.bias": "ffn_norm_bias",
    "post_self_attn_layernorm.weight": "post_attn_norm",  # glm4's sandwich norms
    "post_mlp_layernorm.weight": "post_ffn_norm",
    "self_attn.dense.weight": "wo",  # phi2
    "self_attn.dense.bias": "wo_bias",
    "mlp.fc1.weight": "up",  # phi2's gateless MLP
    "mlp.fc1.bias": "up_bias",
    "mlp.fc2.weight": "down",
    "mlp.fc2.bias": "down_bias",
}
# phi3's (and glm's gate_up) fused projections, split at load (JAX
# hf_loader.py's _PHI3_FUSED, :111-114, applied at :242-254)
_FUSED = {"self_attn.qkv_proj.weight": ("wq", "wk", "wv"),
          "mlp.gate_up_proj.weight": ("gate", "up")}
# archs whose MLP has no gate: down(act(up x))
_GATELESS_ARCHS = ("phi2", "starcoder2")
# gemma2/3 use post_attention_layernorm as the *post* norm and
# pre_feedforward_layernorm as the pre-FFN norm
_GEMMA_LAYER_MAP = dict(_HF_LAYER_MAP)
_GEMMA_LAYER_MAP["post_attention_layernorm.weight"] = "post_attn_norm"
# Mixtral's expert banks: block_sparse_moe.experts.N.{w1, w3, w2}
_MIXTRAL_EXPERTS = {"w1": "gate", "w3": "up", "w2": "down"}
# Qwen3-MoE's and qwen2moe's router and expert banks: mlp.experts.N.{gate,
# up, down}_proj
_QWEN_MOE_MAP = {"mlp.gate.weight": "router"}
_QWEN_MOE_EXPERTS = {"gate_proj": "gate", "up_proj": "up", "down_proj": "down"}
# qwen2moe's shared expert (gathered into the layer's "shared_expert" dict)
# and its per-token gate
_SHARED_EXPERT = {f"mlp.shared_expert.{hf}.weight": f"shared_{key}"
                  for hf, key in _QWEN_MOE_EXPERTS.items()}
_QWEN2_MOE_MAP = {**_SHARED_EXPERT, "mlp.shared_expert_gate.weight": "shared_expert_gate"}
# the MoE archs whose expert banks may come as GPTQ/AWQ triplets
_QUANT_MOE_ARCHS = ("mixtral", "qwen3moe", "qwen2moe")
# q/k/v/o biases (required with attention_bias, taken wherever present)
_ATTN_BIASES = {f"self_attn.{p}_proj.bias": f"w{p}_bias" for p in "qkvo"}
# Qwen3's per-head q/k norms ([head_dim], applied before RoPE; hunyuan's
# query_layernorm/key_layernorm after it)
_QK_NORMS = {"self_attn.q_norm.weight": "q_norm", "self_attn.k_norm.weight": "k_norm",
             "self_attn.query_layernorm.weight": "q_norm",
             "self_attn.key_layernorm.weight": "k_norm"}
# gpt-oss's layer tensors besides the attention projections and norms
_GPT_OSS_MAP = {"self_attn.sinks": "sinks", "mlp.router.weight": "router",
                "mlp.router.bias": "router_bias"}
# gpt-oss's pre-stacked expert banks (HF layout [E, in, out], or the MXFP4
# <stem>_blocks/_scales of the transposed [E, out, in]) and their biases
_GPT_OSS_BANKS = {"gate_up_proj": "gateup", "down_proj": "down"}
# the tensors a GPTQ/AWQ checkpoint stores for a projection <stem>.weight
_GPTQ_PARTS = (".qweight", ".qzeros", ".scales", ".g_idx")


# the port's layer keys that JAX names otherwise (qwen2moe's shared expert)
_JAX_KEYS = {f"shared_{key}": f"se_{key}" for key in _QWEN_MOE_EXPERTS.values()}
# tensors that stay dense under ISQ (JAX hf_loader.py:31)
_NORM_RE = re.compile(r"(norm|layernorm)", re.IGNORECASE)

IsqPlan = Callable[[str, tuple], Optional[GGMLType]]


def default_isq_plan(isq: Optional[GGMLType]) -> IsqPlan:
    """Each tensor's ISQ type by its JAX name and shape (JAX
    ``default_isq_plan``, ``hf_loader.py:137-155``): None (dense) for
    norms, biases, tensors that are not 2-D and K not a multiple of 256
    (the k-quants' super-block); Q8_0 for ``embed`` and ``lm_head``; else
    ``isq``."""

    def plan(name: str, shape: tuple) -> Optional[GGMLType]:
        if isq is None:
            return None
        if len(shape) != 2 or _NORM_RE.search(name) or name.endswith("bias"):
            return None
        if shape[1] % 256 != 0:
            return None
        if "embed" in name or "lm_head" in name:
            return GGMLType.Q8_0
        return isq

    return plan


def _quantize_tensor(w: torch.Tensor, t: GGMLType, dev: torch.device,
                     imatrix_row: Optional[np.ndarray] = None) -> QTensor:
    """One ``[N, K]`` tensor quantized on ``dev`` to type ``t``'s blocks
    (with ``imatrix_row``'s importance weights where its length is K) and
    decoded into planes there, N zero-padded to a multiple of 16 (JAX
    ``_quantize_tensor``, ``hf_loader.py:121-134``)."""
    w = w.to(dev)
    weights = None
    if imatrix_row is not None and imatrix_row.shape[-1] == w.shape[-1]:
        weights = torch.from_numpy(np.asarray(imatrix_row, np.float32)).to(dev)
    raw = quantize(w, t, weights)
    qt = QTensor.from_planar(to_planar(raw, t), tuple(w.shape), ggml_type=t, device=dev)
    return qt.pad_rows(16)


def _quant_method(quant_config: Optional[Mapping[str, Any]], cfg: ModelConfig) -> Optional[str]:
    """The checkpoint's quantization, ``"mxfp4"``, ``"gptq"``, ``"awq"`` or
    None, once it is known to be ported; raises ``NotImplementedError``
    naming what is not."""
    if not quant_config:
        return None
    method = quant_config.get("quant_method")
    if method == "mxfp4" and cfg.arch == "gpt_oss":
        return method
    if method == "bitsandbytes":
        if quant_config.get("load_in_8bit"):
            raise NotImplementedError("HF loader: bitsandbytes 8-bit (LLM.int8) not ported "
                                      "(4-bit NF4/FP4 only, as in the JAX package)")
        return method
    if method in ("gptq", "awq"):
        bits = int(quant_config.get("bits", 4))
        version = str(quant_config.get("version", "gemm")).lower()
        if cfg.num_experts and cfg.arch not in _QUANT_MOE_ARCHS:
            raise NotImplementedError(
                f"HF loader: {method} expert banks of arch {cfg.arch!r} ({cfg.num_experts} "
                f"experts) not ported (only {', '.join(_QUANT_MOE_ARCHS)})")
        if bits not in ((4,) if method == "awq" else (4, 8)):
            raise NotImplementedError(f"HF loader: {method} at {bits} bits not ported")
        if method == "awq" and version != "gemm":
            raise NotImplementedError(f"HF loader: AWQ packing {version!r} not ported (gemm only)")
        return method
    raise NotImplementedError(
        f"HF loader: quantized checkpoint (quantization_config {method!r}: MXFP4 outside "
        f"gpt-oss, ...) not ported yet")


def _deinterleave(t: torch.Tensor) -> torch.Tensor:
    """Columns (last axis) 0, 2, 4, ... then 1, 3, 5, ...: gpt-oss's
    interleaved gate/up outputs as a gate half and an up half."""
    return torch.cat([t[..., 0::2], t[..., 1::2]], dim=-1)


def _gpt_oss_experts(sd, lp: str, dtype, dev, mxfp4: bool) -> dict:
    """One layer's gpt-oss banks in the port's layout: ``gateup`` [E, 2I,
    H], ``gateup_bias`` [E, 2I], ``down`` [E, H, I], ``down_bias`` [E, H]."""
    out = {}
    for hf, key in _GPT_OSS_BANKS.items():
        stem = f"{lp}mlp.experts.{hf}"
        if mxfp4 and stem + "_blocks" in sd:  # decoded [E, out, in]
            bank = decode_mxfp4_param(sd, stem, dev, dtype).transpose(1, 2)
        else:
            bank = sd[stem].to(device=dev, dtype=dtype)
        bias = sd[stem + "_bias"].to(device=dev, dtype=dtype)
        if key == "gateup":
            bank, bias = _deinterleave(bank), _deinterleave(bias)
        out[key], out[key + "_bias"] = bank.transpose(1, 2).contiguous(), bias.contiguous()
    return out


def _stack_bank(xs: list):
    """A layer's decoded experts as one bank: planar QTensors through
    ``QTensor.stack``, dense tensors through ``torch.stack``."""
    if all(isinstance(x, QTensor) for x in xs):
        return QTensor.stack(xs)
    if any(isinstance(x, QTensor) for x in xs):
        raise NotImplementedError("HF loader: a bank mixing quantized and dense experts")
    return torch.stack(xs)


def weights_from_state_dict(
    sd: Mapping[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    dtype=torch.bfloat16,
    device: DeviceLike = None,
    quant_config: Optional[Mapping[str, Any]] = None,
    isq: Optional[GGMLType] = None,
    isq_plan: Optional[IsqPlan] = None,
    imatrix: Optional[Mapping[str, np.ndarray]] = None,
    topology=None,
) -> dict:
    """The port's llama-family weight dict (``models/llama.py``) from a HF
    state dict (dense tensors; gpt-oss's MXFP4 banks with ``quant_config``
    ``{"quant_method": "mxfp4"}``; GPTQ/AWQ projections with ``"gptq"`` or
    ``"awq"``, decoded to planar QTensors), every dense leaf cast to
    ``dtype`` on ``device`` (``cuda`` unless the caller asks for ``"cpu"``;
    gpt-oss's sinks to f32 after that): JAX ``weights_from_state_dict``'s
    path, the same tensors to the same weights (gpt-oss's banks in the
    kernel's layout, above; GPTQ/AWQ experts stacked into planar banks).
    With ``isq`` (or a plan of one's own, ``isq_plan(name, shape)``),
    ``imatrix`` and ``topology`` (``topology.py``: each layer's type where
    it names one): in-situ quantization (module docstring). Tensors that
    are already QTensors (a UQFF overlay's) stay as they are, their rows
    padded to 16. A tensor of any
    other name (a gated MLP's biases, GPTQ/AWQ words of a fused projection,
    q/k norms of a config without ``qk_norm``, expert banks other than
    Mixtral's, Qwen3-MoE's,
    qwen2moe's and gpt-oss's, a router, shared-expert gate or ``lm_head``
    stored as GPTQ/AWQ words) raises ``NotImplementedError`` naming it."""
    gpt_oss = cfg.arch == "gpt_oss"
    method = _quant_method(quant_config, cfg)
    gptq_awq = method in ("gptq", "awq")
    check_supported(cfg)
    dev = resolve_device(device)
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    layer_map = dict(_GEMMA_LAYER_MAP if cfg.arch in ("gemma2", "gemma3") else _HF_LAYER_MAP)
    layer_map.update(_ATTN_BIASES)
    if cfg.qk_norm:
        layer_map.update(_QK_NORMS)
    if gpt_oss:
        layer_map.update(_GPT_OSS_MAP)
    qwen_moe = cfg.arch in ("qwen3moe", "qwen2moe")
    if qwen_moe:
        layer_map.update(_QWEN_MOE_MAP)
    if cfg.arch == "qwen2moe":
        layer_map.update(_QWEN2_MOE_MAP)
    stem, names = (("mlp.experts", _QWEN_MOE_EXPERTS) if qwen_moe
                   else ("block_sparse_moe.experts", _MIXTRAL_EXPERTS))
    experts = {f"{stem}.{j}.{w}.weight": (j, key)
               for j in range(cfg.num_experts) for w, key in names.items()}
    banks = [f"mlp.experts.{hf}{tail}" for hf in _GPT_OSS_BANKS
             for tail in ("", "_bias", "_blocks", "_scales")] if gpt_oss else []
    projections = [suffix for suffix in layer_map if suffix.endswith("_proj.weight")]
    quantized = [suffix[:-len(".weight")] + part for suffix in (*projections, *experts)
                 for part in _GPTQ_PARTS] if gptq_awq else []
    if method == "bitsandbytes":
        quantized = [n for suffix in (*projections, *_FUSED, *experts)
                     for n in side_tensor_names(suffix)]
    known = {prefix + f"{norm}.{p}" for norm in ("norm", "final_layernorm")
             for p in ("weight", "bias")} | {prefix + "embed_tokens.weight", "lm_head.weight",
                                             "lm_head.bias"}
    for i in range(cfg.num_layers):
        known.update(f"{prefix}layers.{i}.{suffix}"
                     for suffix in (*layer_map, *_FUSED, *experts, *banks, *quantized))
    unknown = sorted(n for n in sd if n not in known and not n.endswith("rotary_emb.inv_freq"))
    if unknown:
        raise NotImplementedError(f"HF loader: tensors not ported: {unknown[:8]}")

    bits = int((quant_config or {}).get("bits", 4))
    zero_offset = 0 if (quant_config or {}).get("checkpoint_format") == "gptq_v2" else 1
    plan = isq_plan or default_isq_plan(isq)

    def stored(name: str):
        """``name``'s tensor as the checkpoint holds it, a bitsandbytes
        weight decoded on ``dev`` (f32); None where absent."""
        if method == "bitsandbytes" and not isinstance(sd.get(name), QTensor):
            dec = decode_bnb_param(sd, name, dev)
            if dec is not None:
                return dec
        return sd.get(name)

    def dense(t, plan_name: Optional[str], layer: int):
        """A checkpoint tensor on ``dev``: in ``dtype``, or quantized where
        the plan (a layer's: the topology's type for it, where it names
        one) gives ``plan_name`` a type; a QTensor as it is, its rows
        padded to 16."""
        if isinstance(t, QTensor):
            return t.to(dev).pad_rows(16)
        qtype = None if plan_name is None else plan(plan_name, tuple(t.shape))
        if qtype is not None and topology is not None and plan_name.startswith("layers."):
            qtype = topology.type_for_layer(layer) or qtype
        if qtype is None:
            return t.to(device=dev, dtype=dtype)
        rows = imatrix_rows_for_key(imatrix, plan_name[len("layers."):])
        return _quantize_tensor(t, qtype, dev, None if rows is None else rows[layer % len(rows)])

    def take(name: str, plan_name: Optional[str] = None, layer: int = 0):
        """``name``'s tensor on ``dev``: dense in ``dtype``, quantized where
        the plan gives ``plan_name`` a type, or decoded from GPTQ/AWQ words
        or bitsandbytes codes; None where the checkpoint lacks it."""
        t = stored(name)
        if t is not None:
            return dense(t, plan_name, layer)
        stem = name[:-len(".weight")]
        if not (gptq_awq and name.endswith(".weight") and stem + ".qweight" in sd):
            return None
        qw, qz, sc = (sd[stem + p].to(dev) for p in _GPTQ_PARTS[:3])
        if method == "awq":
            return awq_to_qtensor(qw, qz, sc, bits=bits)
        g_idx = sd.get(stem + ".g_idx")
        return gptq_to_qtensor(qw, qz, sc, g_idx=None if g_idx is None else g_idx.to(dev),
                               bits=bits, zero_offset=zero_offset)

    layers = []
    for i in range(cfg.num_layers):
        lp = f"{prefix}layers.{i}."
        lw = {key: t for suffix, key in layer_map.items()
              if (t := take(lp + suffix, f"layers.{_JAX_KEYS.get(key, key)}", i)) is not None}
        for suffix, keys in _FUSED.items():  # split at load, each part as its own tensor
            t = stored(lp + suffix)
            if t is not None:
                sizes = ([cfg.q_dim, cfg.kv_dim, cfg.kv_dim] if len(keys) == 3
                         else [t.shape[0] // 2] * 2)
                for key, part in zip(keys, t.split(sizes)):
                    lw[key] = dense(part, f"layers.{key}", i)
        if gpt_oss:
            lw["experts"] = _gpt_oss_experts(sd, lp, dtype, dev, method == "mxfp4")
            if "sinks" in lw:
                lw["sinks"] = lw["sinks"].to(torch.float32)
        elif cfg.num_experts:
            bank: dict[str, list] = {key: [None] * cfg.num_experts
                                     for key in _MIXTRAL_EXPERTS.values()}
            for suffix, (j, key) in experts.items():
                bank[key][j] = take(lp + suffix, f"layers.exp_{key}", i)
            if all(x is not None for xs in bank.values() for x in xs):
                lw["experts"] = {key: _stack_bank(xs) for key, xs in bank.items()}
            del bank  # each expert's own planes: gone before the next layer's are decoded
            shared = {key[len("shared_"):]: lw.pop(key) for key in _SHARED_EXPERT.values()
                      if key in lw}
            if len(shared) == len(_SHARED_EXPERT):
                lw["shared_expert"] = shared
        want = {"attn_norm", "wq", "wk", "wv", "wo"} | (
            set() if cfg.parallel_residual else {"ffn_norm"}) | (
            {"router", "experts"} if cfg.num_experts else
            {"up", "down"} | (set() if cfg.arch in _GATELESS_ARCHS else {"gate"})) | (
            {"shared_expert", "shared_expert_gate"} if cfg.arch == "qwen2moe" else set()) | (
            # glm's attention_bias is q/k/v's alone; an o bias is taken where present
            {"wq_bias", "wk_bias", "wv_bias"} if cfg.attention_bias else set()) | (
            set(_QK_NORMS.values()) if cfg.qk_norm else set()) | (
            set(_GPT_OSS_MAP.values()) if gpt_oss else set())
        missing = want - set(lw)
        if missing:
            raise ValueError(f"HF loader: layer {i} lacks {sorted(missing)}")
        layers.append(lw)
    embed = take(prefix + "embed_tokens.weight", "embed_tokens")
    # phi2 names its final norm final_layernorm (JAX hf_loader.py:384-391)
    final = "norm" if prefix + "norm.weight" in sd else "final_layernorm"
    final_norm = take(prefix + final + ".weight")
    if embed is None or final_norm is None:
        raise ValueError("HF loader: embed_tokens.weight or norm.weight missing")
    out = {
        "embed": embed,
        "layers": layers,
        "final_norm": final_norm,
        "lm_head": take("lm_head.weight", "lm_head"),  # None: tied to the embedding
    }
    for key, name in (("final_norm_bias", prefix + final + ".bias"),
                      ("lm_head_bias", "lm_head.bias")):  # LayerNorm archs; phi2's head
        if name in sd:
            out[key] = take(name)
    return out


def load_hf_model(
    path: str | os.PathLike,
    *,
    dtype=torch.bfloat16,
    device: DeviceLike = None,
    isq: Optional[GGMLType] = None,
    imatrix: Optional[Mapping[str, np.ndarray]] = None,
    topology=None,
    from_uqff: Optional[str] = None,
) -> tuple[ModelConfig, dict, dict[str, Any]]:
    """A llama-family HF directory (``config.json`` + safetensors) →
    ``(config, weights on device, config dict)``, quantized in situ to
    ``isq`` (with ``imatrix``'s rows and ``topology``'s types) where given,
    with a mistral.rs UQFF file's layers over the checkpoint's where
    ``from_uqff`` names one."""
    from ..uqff import load_reference_uqff

    path = Path(path)
    hf_cfg = json.loads((path / "config.json").read_text())
    cfg = config_from_hf(hf_cfg)
    sd = load_safetensors_dir(path, resolve_device(device))
    if from_uqff is not None:
        sd.update(load_reference_uqff(from_uqff, device=device))
    weights = weights_from_state_dict(sd, cfg, dtype=dtype, device=device,
                                      quant_config=hf_cfg.get("quantization_config"),
                                      isq=isq, imatrix=imatrix, topology=topology)
    return cfg, weights, hf_cfg
