"""Model loading entry point (counterpart of ``mistralrs_tpu/pipeline.py``):
a ``.gguf`` path (archs ``llama``, Mixtral included, ``qwen2``, ``qwen3``,
``qwen3moe``, in any of the ten planar types of ``gguf/planar.py``; the
loader refuses ``gemma2``, ``gemma3``, ``qwen2moe``, ``granite`` and other
archs by name), a HF directory of the llama family (dense
checkpoints whose ``architectures[0]`` is in ``HF_ARCH_MAP`` and whose
features the decoder takes: Llama, Mistral, Mixtral, Gemma-2, Gemma-3 text
(``Gemma3ForCausalLM``), Qwen2 and Qwen2.5, Qwen3, Qwen3-MoE, Phi-2, Phi-3,
StarCoder2, StableLM, Cohere, Granite, GLM, GLM-4, SmolLM3, Hunyuan dense,
...; and
gpt-oss, in bf16 or with its MXFP4 expert banks), or a HF
directory of the DeepSeek family (``model_type`` ``deepseek_v2``,
``deepseek_v3``, ``glm4_moe_lite``) → config, weights on the device,
tokenizer, chat template and, for DeepSeek, the engine's arch adapter.

``isq`` (a name of :data:`ISQ_NAMES`, as JAX ``parse_isq`` reads it, or a
``GGMLType``) quantizes a llama-family HF directory in situ as it loads, on
the device (``models/hf_loader.py``), with the importance rows of an
``imatrix`` ``.npz`` where given, and ``from_uqff`` overlays a mistral.rs
UQFF file's layers on it. As in the JAX package, a ``.gguf`` file
and a DeepSeek-family directory load unquantized whatever ``isq`` says
(JAX ``pipeline.py:383-395``, ``_load_specialized`` :423-442); the port
says so on stderr. A ``.uqff`` path is a ``uqff_tpu`` file of either
package (``uqff.py::load_uqff``: planar QTensors, FP8 and HQQ weights as
saved; JAX ``pipeline.py:377-381``), with the ``tokenizer.json`` beside it
where there is one (the JAX package loads none); a mistral.rs UQFF file
there is refused by name, as it loads only as an overlay. Other HF
directories (``Gemma3ForConditionalGeneration``, Gemma-3 with its vision
tower, by name) raise ``NotImplementedError``."""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import torch

from ._device import DeviceLike, resolve_device
from .chat_template import ChatTemplate, resolve_chat_template
from .gguf.constants import GGMLType
from .models.config import HF_ARCH_MAP, ModelConfig
from .models.gguf_loader import load_gguf_model
from .tokenizer import TokenizerWrapper, from_gguf_metadata, from_hf_dir

# in-situ quantization names (JAX pipeline.py:21-32)
ISQ_NAMES = {
    "q4k": GGMLType.Q4_K,
    "q4_k": GGMLType.Q4_K,
    "q5k": GGMLType.Q5_K,
    "q5_k": GGMLType.Q5_K,
    "q6k": GGMLType.Q6_K,
    "q6_k": GGMLType.Q6_K,
    "q8_0": GGMLType.Q8_0,
    "q8": GGMLType.Q8_0,
    "q4_0": GGMLType.Q4_0,
    "q5_0": GGMLType.Q5_0,
}


def parse_isq(name: Optional[str]) -> Optional[GGMLType]:
    """An ISQ name (case and surrounding spaces ignored; ``"none"`` and
    ``""`` mean none) → its GGUF type; an unknown name raises the JAX
    package's ``ValueError``."""
    if name is None:
        return None
    key = name.strip().lower()
    if key in ("none", ""):
        return None
    if key not in ISQ_NAMES:
        raise ValueError(f"unknown ISQ type {name!r}; supported: {sorted(ISQ_NAMES)}")
    return ISQ_NAMES[key]


def _warn_unquantized(what: str, isq: Optional[GGMLType]) -> None:
    if isq is not None:
        print(f"warning: {what} loads unquantized; in-situ quantization to {isq.name} "
              f"is ignored, as the JAX package ignores it", file=sys.stderr)

# HF model types served through an arch adapter (JAX pipeline.py:61): the
# DeepSeek family, to which GLM-4-MoE-Lite belongs
DEEPSEEK_ARCHS = ("deepseek_v2", "deepseek_v3", "glm4_moe_lite")
# multimodal HF architectures whose text model the port has, refused by name:
# their towers come with the multimodal work
MULTIMODAL_ARCHS = {
    "Gemma3ForConditionalGeneration": "Gemma-3 with its vision tower (the JAX package "
    "serves it through models/gemma3_vl.py); a Gemma3ForCausalLM directory serves",
}


@dataclass
class Pipeline:
    cfg: ModelConfig
    weights: dict
    tokenizer: Optional[TokenizerWrapper]
    chat_template: ChatTemplate
    model_id: str
    metadata: dict[str, Any]
    # the engine's arch adapter (engine/adapters.py); None for the llama decoder
    adapter: Optional[Any] = None


def load_pipeline(
    model_path: str,
    *,
    isq: Optional[str | GGMLType] = None,
    dtype=torch.bfloat16,
    chat_template_override: Optional[str] = None,
    device: DeviceLike = None,
    imatrix: Optional[str] = None,
    from_uqff: Optional[str] = None,
) -> Pipeline:
    """Load a ``.gguf`` checkpoint (llama, mistral, qwen2, qwen3,
    qwen3moe), a ``.uqff`` file, or a llama- or DeepSeek-family HF
    directory, onto ``device`` (``cuda`` unless the caller asks for
    ``"cpu"``); a llama-family directory quantized in situ to ``isq`` (with
    the ``imatrix`` ``.npz``'s importance rows) and overlaid with the
    ``from_uqff`` mistral.rs UQFF file, as JAX ``load_pipeline`` does."""
    dev = resolve_device(device)
    isq_t = parse_isq(isq) if isinstance(isq, str) else isq
    path = Path(model_path)
    if path.is_dir():
        return _load_hf_dir(path, dtype, chat_template_override, dev, isq_t, imatrix,
                            from_uqff)
    if path.is_file() and path.suffix == ".uqff":
        return _load_uqff(path, dtype, chat_template_override, dev, isq_t)
    if not (path.is_file() and path.suffix == ".gguf"):
        raise FileNotFoundError(
            f"model path {model_path!r}: not a .gguf/.uqff file or a directory")
    _warn_unquantized(f"GGUF file {path.name}", isq_t)
    cfg, weights, md = load_gguf_model(str(path), dtype=dtype, device=dev)
    try:
        tokenizer = from_gguf_metadata(md)
    except (KeyError, NotImplementedError, ImportError) as e:
        print(f"warning: no tokenizer from GGUF metadata ({type(e).__name__}: {e})",
              file=sys.stderr)
        tokenizer = None
    ct = resolve_chat_template(override=chat_template_override, gguf_metadata=md,
                               arch=cfg.arch)
    return Pipeline(cfg, weights, tokenizer, ct, path.stem, md)


def _tokenizer(path: Path):
    try:
        return from_hf_dir(path)
    except FileNotFoundError:
        return None


def _load_uqff(path: Path, dtype, chat_template_override, dev, isq) -> Pipeline:
    """A ``uqff_tpu`` file (JAX ``pipeline.py:377-381``)."""
    from .uqff import is_reference_uqff, load_uqff

    if is_reference_uqff(str(path)):
        raise ValueError(f"{path.name} is a mistral.rs UQFF file: it holds quantized layers "
                         f"only, and loads as the from_uqff= overlay (serve --from-uqff) of "
                         f"its HF directory, as in the JAX package")
    _warn_unquantized(f"UQFF file {path.name}", isq)
    cfg, weights = load_uqff(str(path), device=dev, dtype=dtype)
    ct = resolve_chat_template(override=chat_template_override, arch=cfg.arch)
    tokenizer = _tokenizer(path.parent) if (path.parent / "tokenizer.json").exists() else None
    return Pipeline(cfg, weights, tokenizer, ct, path.stem, {})


def _load_hf_dir(path: Path, dtype, chat_template_override, dev, isq, imatrix,
                 from_uqff=None) -> Pipeline:
    """A llama-family HF directory (JAX ``pipeline.py``'s HF branch, through
    ``models/hf_loader.py::load_hf_model``), or a DeepSeek-family one (JAX
    ``pipeline.py:240-257`` and ``make_adapter`` at :325-352)."""
    from .engine.adapters import DeepseekAdapter
    from .imatrix import load_imatrix
    from .models.deepseek import DeepseekConfig, deepseek_weights_from_state_dict
    from .models.hf_loader import load_hf_model, load_safetensors_dir

    cfg_file = path / "config.json"
    hf_cfg = json.loads(cfg_file.read_text()) if cfg_file.exists() else {}
    model_type = hf_cfg.get("model_type", "")
    archs = hf_cfg.get("architectures") or []
    if archs and archs[0] in MULTIMODAL_ARCHS:
        raise NotImplementedError(f"HF directory {path}: {archs[0]} is not ported: "
                                  f"{MULTIMODAL_ARCHS[archs[0]]}")
    if model_type not in DEEPSEEK_ARCHS:
        if not archs or archs[0] not in HF_ARCH_MAP:
            raise NotImplementedError(
                f"HF directory {path}: architectures {archs} / model_type {model_type!r} are "
                f"not ported (llama family: {sorted(HF_ARCH_MAP)}; {DEEPSEEK_ARCHS})")
        im = None if imatrix is None else load_imatrix(imatrix)
        cfg, weights, hf_cfg = load_hf_model(path, dtype=dtype, device=dev, isq=isq, imatrix=im,
                                             from_uqff=from_uqff)
        ct = resolve_chat_template(override=chat_template_override, hf_dir=path, arch=cfg.arch)
        return Pipeline(cfg, weights, _tokenizer(path), ct, path.name, hf_cfg)
    _warn_unquantized(f"{model_type} directory {path.name}", isq)
    if from_uqff is not None:
        raise NotImplementedError(f"{model_type} directory {path.name}: a UQFF overlay is "
                                  f"not ported for the DeepSeek family")
    cfg = DeepseekConfig.from_hf(hf_cfg)
    weights = deepseek_weights_from_state_dict(load_safetensors_dir(path, dev), cfg,
                                               dtype=dtype, device=dev)
    ct = resolve_chat_template(override=chat_template_override, hf_dir=path, arch=model_type)
    adapter = DeepseekAdapter(cfg, weights, compute_dtype=dtype, device=dev)
    return Pipeline(cfg, weights, _tokenizer(path), ct, path.name, hf_cfg, adapter=adapter)
