"""Command-line interface (counterpart of ``mistralrs_tpu/cli.py``): the
``serve`` command only.

    python -m mistralrs_tpu_torch.cli serve model.gguf --port 8080
    python -m mistralrs_tpu_torch.cli serve model.gguf --kv-quant int8
    python -m mistralrs_tpu_torch.cli serve qwen2.5-7b-instruct-q5_k_m.gguf --port 8080
    python -m mistralrs_tpu_torch.cli serve path/to/gemma-2-9b --port 8080
    python -m mistralrs_tpu_torch.cli serve path/to/gemma-3-12b --kv-quant int8
    python -m mistralrs_tpu_torch.cli serve path/to/DeepSeek-V2-Lite --port 8080
    python -m mistralrs_tpu_torch.cli serve path/to/gpt-oss-20b --port 8080
    python -m mistralrs_tpu_torch.cli serve path/to/Qwen2.5-7B-Instruct --port 8080
    python -m mistralrs_tpu_torch.cli serve path/to/Qwen3-30B-A3B --port 8080
    python -m mistralrs_tpu_torch.cli serve path/to/Meta-Llama-3.1-8B-Instruct --isq q4k
    python -m mistralrs_tpu_torch.cli serve path/to/Phi-3-mini-4k-instruct --port 8080
    python -m mistralrs_tpu_torch.cli serve path/to/phi-2 --isq q4k

A ``.gguf`` file (archs ``llama``, Mixtral included, ``qwen2``, ``qwen3``
and ``qwen3moe``; every planar type: Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K,
Q3_K, Q4_K, Q5_K, Q6_K, and F16/BF16/F32) and a llama-family HF directory (``config.json`` +
safetensors + ``tokenizer.json``: Llama, Mistral, Mixtral, Gemma-2, Gemma-3
text, Qwen2 and Qwen2.5, Qwen3, Qwen3-MoE, Phi-2, Phi-3, StarCoder2, StableLM,
Cohere, Granite, GLM, GLM-4, SmolLM3, Hunyuan (dense), dense bf16/f16/f32 tensors; gpt-oss with
dense or MXFP4 expert banks, decoded to bf16 at load) serve through the
llama decoder; a DeepSeek-family HF
directory through its arch adapter.
``--kv-quant int8|fp8`` serves from 1-byte KV pools (or latent pool) with
per-row scales, sized by their own bytes per token, for every model of the
llama decoder (windows, softcaps, sinks, head_dim 64, 80, 96, 128 and 256).
``--isq q4k|q5k|q6k|q8_0|q4_0|q5_0`` (the JAX package's names) quantizes a
llama-family HF directory on the card as it loads (JAX ``cli.py:17``); a
``.gguf`` file and a DeepSeek directory load unquantized, with a warning.
"""

from __future__ import annotations

import argparse
import sys


def cmd_serve(args) -> int:
    from .engine.engine import Engine
    from .kv.paged import calculate_cache_config
    from .models.llama import fuse_projections
    from .pipeline import load_pipeline
    from .serving.server import Server

    override = None
    if args.chat_template:
        with open(args.chat_template) as f:
            override = f.read()
    pipe = load_pipeline(args.model, isq=args.isq, chat_template_override=override,
                         device=args.device)
    if pipe.tokenizer is None:
        print("error: model has no tokenizer; `serve` needs one", file=sys.stderr)
        return 1
    weights = None
    if pipe.adapter is None:
        weights = fuse_projections(pipe.weights, pipe.cfg)  # in place: no unfused copy stays
    if args.device != "cpu":
        import torch

        torch.cuda.empty_cache()  # the unfused parts' memory counts as free below
    max_len = args.max_seq_len or min(pipe.cfg.max_position_embeddings, 8192)
    num_blocks = args.num_kv_blocks
    if num_blocks is None:
        on_cpu = args.device == "cpu"
        num_blocks = calculate_cache_config(
            pipe.cfg, block_size=args.block_size, max_model_len=max_len,
            max_batch=args.max_batch, device=args.device or "cuda",
            mem_bytes=(16 << 30) if on_cpu else None,  # CPU: a 16 GiB budget
            kv_quant=args.kv_quant is not None,
            bytes_per_token=(pipe.adapter.kv_bytes_per_token(args.kv_quant)
                             if pipe.adapter else None),
        )
    eng = Engine(
        pipe.cfg, weights, num_blocks=num_blocks, block_size=args.block_size,
        max_batch=args.max_batch, max_model_len=max_len,
        prefill_chunk=args.prefill_chunk, kv_quant=args.kv_quant, tokenizer=pipe.tokenizer,
        device=args.device, adapter=pipe.adapter,
    )
    server = Server(eng, pipe.tokenizer, pipe.chat_template, pipe.model_id,
                    host=args.host, port=args.port)
    host, port = server.address
    print(f"serving {pipe.model_id} on {host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="mistralrs_tpu_torch", description="quantized LLM serving on one CUDA GPU"
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("serve", help="OpenAI-compatible HTTP server")
    p.add_argument("model", help="a .gguf file (llama, qwen2, qwen3, qwen3moe), or a "
                                 "llama- or DeepSeek-family HF directory")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--isq", default=None, help="in-situ quantization (q4k, q8_0, ...)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--block-size", type=int, default=64, help="paged KV block tokens")
    p.add_argument("--num-kv-blocks", type=int, default=None,
                   help="KV blocks (default: fill free device memory)")
    p.add_argument("--max-seq-len", type=int, default=None)
    p.add_argument("--prefill-chunk", type=int, default=512)
    p.add_argument("--kv-quant", choices=["int8", "fp8"], default=None,
                   help="1-byte KV cache with per-row scales (default: the compute dtype)")
    p.add_argument("--chat-template", default=None, help="jinja template override file")
    p.set_defaults(fn=cmd_serve)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
