"""Model loading entry point (counterpart of ``mistralrs_tpu/pipeline.py``):
a ``.gguf`` path → config, weights on the device, tokenizer and chat
template. HF directories, UQFF files and in-situ quantization are not ported
yet and raise ``NotImplementedError``."""

from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import torch

from ._device import DeviceLike, resolve_device
from .chat_template import ChatTemplate, resolve_chat_template
from .models.config import ModelConfig
from .models.gguf_loader import load_gguf_model
from .tokenizer import TokenizerWrapper, from_gguf_metadata


@dataclass
class Pipeline:
    cfg: ModelConfig
    weights: dict
    tokenizer: Optional[TokenizerWrapper]
    chat_template: ChatTemplate
    model_id: str
    metadata: dict[str, Any]


def load_pipeline(
    model_path: str,
    *,
    dtype=torch.bfloat16,
    chat_template_override: Optional[str] = None,
    device: DeviceLike = None,
) -> Pipeline:
    """Load a llama ``.gguf`` checkpoint onto ``device`` (``cuda`` unless the
    caller asks for ``"cpu"``)."""
    dev = resolve_device(device)
    path = Path(model_path)
    if not (path.is_file() and path.suffix == ".gguf"):
        raise NotImplementedError(
            f"model path {model_path!r}: only .gguf files are ported so far"
        )
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
