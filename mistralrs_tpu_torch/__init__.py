"""PyTorch/CUDA port of ``mistralrs_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's layout (``ops/quant_matmul.py`` here is
the counterpart of ``mistralrs_tpu/ops/quant_matmul.py``) and serves the
llama path, dense or with Mixtral-style experts (GGUF k-quant weights, the
paged KV cache), and DeepSeek V2/V3 HF checkpoints (absorbed MLA over a paged
latent pool, through an engine adapter), with the continuous-batching engine
and an OpenAI-compatible HTTP server. Every Pallas kernel on those paths
is a hand-written CUDA C++ kernel under ``csrc/``, built with ``nvcc`` on first
use. The package imports ``torch`` and ``numpy``, never ``jax``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit ``"cpu"`` they raise.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
