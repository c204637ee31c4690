"""UQFF files (counterpart of ``mistralrs_tpu/uqff.py``): pre-quantized
models in a safetensors container.

Two formats:

* The JAX package's ``uqff_tpu`` file (:func:`save_uqff`, :func:`load_uqff`):
  the whole weight tree with every layer leaf stacked ``[L, ...]`` (QTensor
  planes as ``<key>.data``/``.scale``/``.bias``, FP8 codes ``[L, N, K]`` as
  bytes with their scales, bf16 tensors as their 16-bit patterns, norms and
  embeddings), plus a ``uqff_tpu`` metadata string: the config and each
  entry's kind and static fields. The port writes the JAX layout (K-major
  planes, padded rows cut back to their ``logical_n``, FP8 codes ``[N, K]``,
  the ``layer_windows``/``layer_use_rope`` leaves the JAX model reads), and
  reads a file of either package through ``convert.py::from_jax_params``, so
  a file written by either loads in the other. Layers are stacked as they
  are written, one layer's tensor copied to the host at a time; on load each
  entry is copied to the device as it is read, then split per layer there.
* mistral.rs's UQFF v1.x (:func:`is_reference_uqff`,
  :func:`load_reference_uqff`, :func:`save_reference_uqff`): version scalars
  ``uqff.version.{major,minor,patch}`` (u32) and, per layer,
  ``<prefix>.weight.format`` (u8 serde tag: 0 GGUF, 1 unquantized) with
  GGUF layers' raw GGML blocks, dtype code and shape. The JAX package reads
  it only as an overlay of a HF directory (``from_uqff=``), and so does the
  port; the files the port writes are the JAX package's, byte for byte.

Neither ``safetensors`` nor ``ml_dtypes`` is needed: files are read and
written by ``models/hf_loader.py``'s own reader and writer.
"""

from __future__ import annotations

import json
from dataclasses import asdict, fields
from typing import Any, Mapping, Optional

import torch

from ._device import DeviceLike, resolve_device
from .convert import from_jax_params
from .gguf.constants import GGMLType, type_traits
from .gguf.quants import QUANT_TYPES, quantize
from .models.config import ModelConfig, layer_rope_flags, layer_windows
from .models.hf_loader import SafetensorsFile, write_safetensors
from .quant.fp8 import Fp8Tensor
from .quant.qtensor import QTensor

UQFF_TPU_VERSION = 1


# ---------------------------------------------------------------------------
# the JAX package's uqff_tpu file
# ---------------------------------------------------------------------------


def _stack_entry(key: str, leaves: list, tensors: dict, meta: dict) -> None:
    """One weight (``leaves``: its value in each layer, or ``[value]`` for a
    leaf outside the layers, then ``stacked=False``) as the JAX package's
    entries: ``tensors[key + ...]`` (lists are stacked by the writer) and
    ``meta[key]``."""
    first = leaves[0]
    stacked = len(leaves) > 1 or key.startswith("layers.")

    def put(name, parts):
        tensors[name] = parts if stacked else parts[0]

    if first is None:
        if any(v is not None for v in leaves):
            raise NotImplementedError(f"save_uqff: {key} is absent from some layers only")
        meta[key] = {"kind": "none"}
    elif isinstance(first, QTensor):
        sig = [(v.data.shape, v.data.dtype, v.group_size, v.packed, v.code_bits,
                v.bias is None, v.ggml_type, v.logical_n) if isinstance(v, QTensor) else None
               for v in leaves]
        if len(set(sig)) != 1:
            raise NotImplementedError(
                f"save_uqff: {key} has layers of different formats ({len(set(sig))} kinds); "
                f"a uqff_tpu file stacks one format per weight")

        def plane(v, p):  # a padded matrix's planes cut back to its logical rows
            return p if v.logical_n is None else p[..., :v.logical_n].contiguous()

        put(key + ".data", [plane(v, v.data) for v in leaves])
        put(key + ".scale", [plane(v, v.scale) for v in leaves])
        if first.bias is not None:
            put(key + ".bias", [plane(v, v.bias) for v in leaves])
        meta[key] = {"kind": "qtensor", "group_size": first.group_size, "packed": first.packed,
                     "code_bits": first.code_bits,
                     "ggml_type": None if first.ggml_type is None else int(first.ggml_type),
                     "chunks": 1, "has_bias": first.bias is not None}
    elif isinstance(first, Fp8Tensor):
        sig = {(v.data.shape, v.block_shape) if isinstance(v, Fp8Tensor) else None
               for v in leaves}
        if len(sig) != 1:
            raise NotImplementedError(f"save_uqff: {key} has layers of different FP8 forms")
        put(key + ".data", [v.data.T.contiguous().view(torch.uint8) for v in leaves])
        put(key + ".scale", [v.scale for v in leaves])
        n, k = first.shape
        meta[key] = {"kind": "fp8",
                     "block_shape": list(first.block_shape) if first.block_shape else None,
                     "shape": [len(leaves), n, k] if stacked else [n, k]}
    elif isinstance(first, torch.Tensor):
        if any(not isinstance(v, torch.Tensor) or v.shape != first.shape
               or v.dtype != first.dtype for v in leaves):
            raise NotImplementedError(f"save_uqff: {key} has layers of different kinds")
        if first.dtype == torch.bfloat16:
            put(key, [v.view(torch.uint16) for v in leaves])
            meta[key] = {"kind": "bf16"}
        else:
            put(key, list(leaves))
            meta[key] = {"kind": "dense"}
    else:
        raise NotImplementedError(f"save_uqff: {key} is a {type(first).__name__}")


def _walk(prefix: str, leaves: list, tensors: dict, meta: dict) -> None:
    """Flatten a (per-layer list of) dict(s) into entries, as JAX
    ``_flatten`` names them (``layers.experts.gate.data``, ...)."""
    first = leaves[0]
    if isinstance(first, dict):
        keys = list(first)
        for lw in leaves:
            if set(lw) != set(keys):
                raise NotImplementedError(
                    f"save_uqff: the layers of {prefix.rstrip('.')} hold different weights")
        for k in keys:
            _walk(f"{prefix}{k}.", [lw[k] for lw in leaves], tensors, meta)
    else:
        _stack_entry(prefix.rstrip("."), leaves, tensors, meta)


def save_uqff(path: str, cfg: ModelConfig, weights: dict) -> None:
    """Write the port's llama-family weights (per-layer dicts of tensors,
    QTensors and Fp8Tensors, on any device) as a ``uqff_tpu`` file the JAX
    package's ``load_uqff`` reads (JAX ``save_uqff``): each layer key
    stacked ``[L, ...]``. Every layer must hold the same weights in the
    same format (a Q4_K_M mix or a topology of several types raises by
    name), and gpt-oss's banks, which the port keeps in another layout,
    are refused."""
    if cfg.arch == "gpt_oss":
        raise NotImplementedError("save_uqff: gpt-oss's expert banks are kept in the port's "
                                  "own layout, not the JAX package's")
    tensors: dict[str, Any] = {}
    meta: dict[str, Any] = {}
    for key, value in weights.items():
        if key == "layers":
            _walk("layers.", value, tensors, meta)
        elif isinstance(value, dict):
            _walk(key + ".", [value], tensors, meta)
        else:
            _stack_entry(key, [value], tensors, meta)
    # the JAX model reads each layer's window and RoPE flag from its weights
    _stack_entry("layer_windows", [torch.from_numpy(layer_windows(cfg))], tensors, meta)
    _stack_entry("layer_use_rope", [torch.from_numpy(layer_rope_flags(cfg))], tensors, meta)
    header = {"uqff_tpu_version": UQFF_TPU_VERSION, "config": asdict(cfg), "entries": meta}
    write_safetensors(path, tensors, metadata={"uqff_tpu": json.dumps(header)})


def _read_entry(f: SafetensorsFile, key: str, ent: dict, dev):
    """One entry of a ``uqff_tpu`` file as the JAX package's leaf, its
    arrays copied to ``dev``: a mapping of QTensor or Fp8Tensor fields, a
    tensor, or None."""
    kind = ent["kind"]
    if kind == "none":
        return None
    if kind == "qtensor":
        return {"data": f.get(key + ".data", dev), "scale": f.get(key + ".scale", dev),
                "bias": f.get(key + ".bias", dev) if ent["has_bias"] else None,
                "group_size": ent["group_size"], "packed": ent["packed"],
                "code_bits": ent["code_bits"], "chunks": ent.get("chunks", 1)}
    if kind == "fp8":
        return {"data": f.get(key + ".data", dev).view(torch.float8_e4m3fn),
                "scale": f.get(key + ".scale", dev),
                "block_shape": tuple(ent["block_shape"]) if ent["block_shape"] else None}
    if kind == "bf16":
        return f.get(key, dev).view(torch.bfloat16)
    return f.get(key, dev)


def load_uqff(path: str, *, device: DeviceLike = None,
              dtype=torch.bfloat16) -> tuple[ModelConfig, dict]:
    """A ``uqff_tpu`` file (of either package) → ``(config, weights on
    device)`` (``cuda`` unless the caller asks for ``"cpu"``), through
    ``convert.py::from_jax_params`` (dense leaves cast to ``dtype``; planes
    and FP8 codes kept bit for bit)."""
    dev = resolve_device(device)
    f = SafetensorsFile(path)
    if "uqff_tpu" not in f.metadata:
        raise ValueError(f"{path}: not a uqff_tpu file (no 'uqff_tpu' metadata)"
                         + ("; it is a mistral.rs UQFF file, which loads as the "
                            "from_uqff= overlay of its HF directory"
                            if "uqff.version.major" in f.header else ""))
    header = json.loads(f.metadata["uqff_tpu"])
    if header["uqff_tpu_version"] > UQFF_TPU_VERSION:
        raise ValueError(f"uqff version {header['uqff_tpu_version']} newer than supported")
    cfg_d = dict(header["config"])
    # JSON keeps tuples as lists: the tuple fields come back as tuples
    tuples = {f.name for f in fields(ModelConfig) if isinstance(f.default, tuple)}
    cfg = ModelConfig(**{k: tuple(v) if k in tuples and v is not None else v
                         for k, v in cfg_d.items()})
    params: dict[str, Any] = {}
    for key, ent in header["entries"].items():
        if key in ("layer_windows", "layer_use_rope"):  # the port derives them from cfg
            continue
        *parents, leaf = key.split(".")
        d = params
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = _read_entry(f, key, ent, dev)
    return cfg, from_jax_params(params, cfg, device=dev, dtype=dtype)


# ---------------------------------------------------------------------------
# mistral.rs UQFF v1.x
# ---------------------------------------------------------------------------

_UQFF_GGML_CODES = {
    0: "F32", 1: "F16", 2: GGMLType.Q4_0, 3: GGMLType.Q4_1,
    6: GGMLType.Q5_0, 7: GGMLType.Q5_1, 8: GGMLType.Q8_0,
    10: GGMLType.Q2_K, 11: GGMLType.Q3_K, 12: GGMLType.Q4_K,
    13: GGMLType.Q5_K, 14: GGMLType.Q6_K, 30: "BF16",
}
_UQFF_GGML_WRITE_CODES = {v: k for k, v in _UQFF_GGML_CODES.items() if not isinstance(v, str)}
_UQFF_WRITE_VERSION = (1, 2, 0)
_SERDE_GGUF, _SERDE_UNQUANT = 0, 1
_DENSE_CODES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
_SENSITIVE_4BIT = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q4_K, GGMLType.Q2_K, GGMLType.Q3_K)


def is_reference_uqff(path: str) -> bool:
    """Whether ``path`` is a safetensors file holding mistral.rs's UQFF
    version scalars."""
    try:
        return "uqff.version.major" in SafetensorsFile(path).header
    except (OSError, ValueError, UnicodeDecodeError, KeyError):  # not a safetensors file
        return False


def load_reference_uqff(path: str, device: DeviceLike = None) -> dict[str, Any]:
    """A mistral.rs UQFF v1.x file → a state dict ``{HF name: QTensor on
    device, or a CPU tensor}`` for ``models/hf_loader.py`` (JAX
    ``load_reference_uqff``): GGUF layers' blocks read onto ``device`` (in
    chunks) and decoded there into planes, their F32/F16/BF16 layers and unquantized
    layers as f32 / stored tensors, biases and the remaining plain tensors
    (norms, embeddings) as stored. A serde type other than GGUF and
    unquantized, an unknown ggml dtype code or a major version other than 1
    raises ``ValueError``, as in the JAX package."""
    dev = resolve_device(device)
    f = SafetensorsFile(path)
    names = set(f.header)
    major = int(f.get("uqff.version.major").reshape(-1)[0])
    if major != 1:
        raise ValueError(f"unsupported UQFF major version {major}")
    consumed = {"uqff.version.major", "uqff.version.minor", "uqff.version.patch"}
    sd: dict[str, Any] = {}
    for name in sorted(names):
        if not name.endswith(".weight.format"):
            continue
        prefix = name[: -len(".weight.format")]
        fmt = int(f.get(name).reshape(-1)[0])
        consumed.add(name)
        if fmt == _SERDE_UNQUANT:
            sd[prefix + ".weight"] = f.get(prefix + ".weight")
            consumed.add(prefix + ".weight")
        elif fmt == _SERDE_GGUF:
            code = int(f.get(prefix + ".weight.dtype").reshape(-1)[0])
            ggml = _UQFF_GGML_CODES.get(code)
            if ggml is None:
                raise ValueError(f"{prefix}: unsupported UQFF ggml dtype code {code}")
            shape = tuple(int(x) for x in f.get(prefix + ".weight.shape").reshape(-1).tolist())
            raw = f.get(prefix + ".weight", "cpu" if isinstance(ggml, str) else dev).reshape(-1)
            consumed |= {prefix + ".weight", prefix + ".weight.dtype", prefix + ".weight.shape"}
            if isinstance(ggml, str):
                sd[prefix + ".weight"] = raw.view(torch.uint8).view(
                    _DENSE_CODES[ggml]).reshape(shape).to(torch.float32)
            else:
                sd[prefix + ".weight"] = QTensor.from_gguf_raw(raw.view(torch.uint8), ggml,
                                                               shape, device=dev)
        else:
            raise ValueError(f"{prefix}: UQFF serde type {fmt} not supported yet "
                             f"(gguf/unquant only)")
        if prefix + ".bias" in names:
            sd[prefix + ".bias"] = f.get(prefix + ".bias")
            consumed.add(prefix + ".bias")
    for name in names - consumed:  # the remaining plain tensors (norms, embeddings)
        if not name.startswith("uqff."):
            sd[name] = f.get(name)
    return sd


def save_reference_uqff(path: str, sd: Mapping[str, torch.Tensor], quant,
                        *, sensitive_boost: bool = True) -> None:
    """Write a mistral.rs UQFF v1.x file from a float state dict (tensors
    on any device; each quantized on its own device), byte for byte the
    JAX ``save_reference_uqff``'s: ``quant`` is one GGML type or a map of
    HF name → type (None: unquantized, with the UNQUANT tag); 1-D tensors
    and widths the type's blocks do not divide stay f32; with
    ``sensitive_boost`` embeddings and heads of a <= 4-bit type take Q8_0."""
    out: dict[str, Any] = {}
    for part, v in zip(("major", "minor", "patch"), _UQFF_WRITE_VERSION):
        out[f"uqff.version.{part}"] = torch.tensor([v], dtype=torch.uint32)

    def type_for(name: str, arr: torch.Tensor) -> Optional[GGMLType]:
        t = quant.get(name) if isinstance(quant, Mapping) else quant
        if t is None or arr.dim() != 2:
            return None
        if sensitive_boost and ("embed" in name or "lm_head" in name or "output.weight" in name):
            t = GGMLType.Q8_0 if t in _SENSITIVE_4BIT else t
        if t not in QUANT_TYPES:
            return None
        return t if arr.shape[-1] % type_traits(t).block_size == 0 else None

    for name, arr in sd.items():
        if not name.endswith(".weight"):
            out[name] = arr.to(torch.float32)
            continue
        prefix = name[: -len(".weight")]
        t = type_for(name, arr)
        if t is None:
            out[name] = arr.to(torch.float32)
            if arr.dim() == 2:  # linear weights keep the serde tag; plain norms do not
                out[name + ".format"] = torch.tensor([_SERDE_UNQUANT], dtype=torch.uint8)
            continue
        out[name] = quantize(arr, t)
        out[name + ".format"] = torch.tensor([_SERDE_GGUF], dtype=torch.uint8)
        out[name + ".dtype"] = torch.tensor([_UQFF_GGML_WRITE_CODES[t]], dtype=torch.uint8)
        out[name + ".shape"] = torch.tensor(list(arr.shape), dtype=torch.uint32)
        bias = sd.get(prefix + ".bias")
        if bias is not None:
            out[prefix + ".bias"] = bias.to(torch.float32)
    write_safetensors(path, out)


def inspect(path: str) -> dict:
    """A UQFF file's inventory without reading its tensors' data beyond the
    small fields (JAX ``cmd_uqff_inspect``): the format, and per tensor its
    name, shape and dtype (``uqff_tpu``) or per layer its quant, dtype code
    and shape (mistral.rs)."""
    f = SafetensorsFile(path)
    out: dict[str, Any] = {"path": str(path), "format": None, "tensors": []}
    keys = list(f.header)
    if "uqff.version.major" in f.header:
        out["format"] = "mistral.rs-uqff"
        for p in sorted({k.rsplit(".", 1)[0] for k in keys if k.endswith(".weight")}):
            entry: dict[str, Any] = {"name": p}
            for field in ("format", "dtype", "shape"):
                k = f"{p}.{field}"
                if k in f.header:
                    v = f.get(k).reshape(-1)
                    if field == "format":
                        code = int(v[0])
                        entry["quant"] = str(_UQFF_GGML_CODES.get(code, code))
                    elif field == "shape":
                        entry["shape"] = [int(x) for x in v.tolist()]
                    else:
                        entry["dtype_code"] = int(v[0])
            out["tensors"].append(entry)
    else:
        out["format"] = "mistralrs_tpu-uqff"
        out["metadata"] = {k: f.metadata[k] for k in sorted(f.metadata)}
        for k in sorted(keys):
            info = f.header[k]
            out["tensors"].append({"name": k, "shape": list(info["shape"]),
                                   "dtype": info["dtype"]})
    out["tensor_count"] = len(out["tensors"])
    return out


__all__ = ["UQFF_TPU_VERSION", "inspect", "is_reference_uqff", "load_reference_uqff",
           "load_uqff", "save_reference_uqff", "save_uqff"]
