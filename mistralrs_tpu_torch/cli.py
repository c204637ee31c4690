"""Command-line interface (counterpart of ``mistralrs_tpu/cli.py``): the
``serve``, ``imatrix``, ``perplexity``, ``quantize`` and ``uqff-inspect``
commands.

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
A ``.uqff`` file (the ``uqff_tpu`` container of either package: planar,
HQQ or FP8 weights, with a ``tokenizer.json`` beside it) serves as saved;
``--from-uqff FILE`` overlays a mistral.rs UQFF file's quantized layers on
a HF directory (JAX ``cli.py:18``). A bitsandbytes NF4/FP4 directory
decodes to dense weights at load (``--isq`` re-quantizes them).

    python -m mistralrs_tpu_torch.cli quantize path/to/Meta-Llama-3.1-8B --quant q4k -o l.gguf
    python -m mistralrs_tpu_torch.cli quantize path/to/Meta-Llama-3.1-8B --quant q4k -o l.uqff
    python -m mistralrs_tpu_torch.cli uqff-inspect l.uqff

``quantize`` (JAX ``cmd_quantize``, ``cli.py:336-374``) writes a GGUF file
(``convert.py::convert_hf_to_gguf``, the tokenizer's metadata included;
``--imatrix`` for the Q4_K/Q5_K fit) or, for a ``.uqff`` output, a
mistral.rs UQFF file (``uqff.py::save_reference_uqff``), quantizing on
``--device``; ``uqff-inspect`` (:532-571) prints a UQFF file's inventory.

    python -m mistralrs_tpu_torch.cli imatrix path/to/Meta-Llama-3.1-8B --text calib.txt -o im.npz
    python -m mistralrs_tpu_torch.cli serve path/to/Meta-Llama-3.1-8B --isq q4k  # with --imatrix
    python -m mistralrs_tpu_torch.cli perplexity path/to/Meta-Llama-3.1-8B eval.txt \
        --compare-isq q4k,q8_0

``imatrix`` (JAX ``cmd_imatrix``, ``cli.py:377-413``) loads a llama-family
HF directory in f32 and runs each non-empty line of ``--text`` (its first
``--chunk`` tokens; lines of fewer than 2 tokens skipped) through
``imatrix.py::ImatrixCollector``, then writes the ``.npz``. ``perplexity``
(JAX ``cmd_perplexity``, :416-456) scores a text file with
``perplexity.py::compute_perplexity``, for the model as stored and then
quantized in situ to each type of ``--compare-isq``: one JSON line each,
with ``delta_ppl`` against ``base``. A DeepSeek-family directory (its own
forward is not ported over a contiguous cache) is refused by both.
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
                         device=args.device, from_uqff=args.from_uqff)
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


def _refuse_adapter(pipe, command: str) -> None:
    if pipe.adapter is not None:
        raise NotImplementedError(f"{command}: {pipe.model_id} runs through an arch adapter "
                                  f"(DeepSeek), whose contiguous-cache forward is not ported")


def cmd_imatrix(args) -> int:
    """Collect an importance matrix over calibration text."""
    import json
    from pathlib import Path

    import numpy as np
    import torch

    from ._device import resolve_device
    from .imatrix import ImatrixCollector, save_imatrix
    from .models.config import config_from_hf
    from .models.hf_loader import load_safetensors_dir, weights_from_state_dict
    from .pipeline import DEEPSEEK_ARCHS
    from .tokenizer import from_file

    src = Path(args.model)
    hf_cfg = json.loads((src / "config.json").read_text())
    if hf_cfg.get("model_type") in DEEPSEEK_ARCHS:
        raise NotImplementedError(f"imatrix: {hf_cfg['model_type']} runs through an arch "
                                  f"adapter, whose contiguous-cache forward is not ported")
    cfg = config_from_hf(hf_cfg)
    dev = resolve_device(args.device)
    weights = weights_from_state_dict(load_safetensors_dir(src), cfg, dtype=torch.float32,
                                      device=dev)
    tok = from_file(src / "tokenizer.json")
    coll = ImatrixCollector(cfg, device=dev)
    with open(args.text) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ids = tok.encode(line)[: args.chunk]
            if len(ids) < 2:
                continue
            coll.update(weights, np.asarray(ids, np.int64)[None])
    save_imatrix(args.output, coll.finalize())
    print(f"wrote {args.output} ({coll.tokens} calibration tokens)")
    return 0


def cmd_quantize(args) -> int:
    """HF safetensors → a quantized GGUF file, or a mistral.rs UQFF file."""
    import json
    from pathlib import Path

    from ._device import resolve_device
    from .convert import convert_hf_to_gguf, tokenizer_metadata_from_hf
    from .imatrix import load_imatrix
    from .models.config import config_from_hf
    from .models.hf_loader import load_safetensors_dir
    from .pipeline import parse_isq
    from .uqff import save_reference_uqff

    src = Path(args.model)
    cfg = config_from_hf(json.loads((src / "config.json").read_text()))
    t = parse_isq(args.quant)
    dev = resolve_device(args.device)
    sd = load_safetensors_dir(src, dev)
    if str(args.output).endswith(".uqff"):
        save_reference_uqff(args.output, sd, t)
    else:
        tok_md = None
        if (src / "tokenizer.json").exists():
            from tokenizers import Tokenizer

            tok_md = tokenizer_metadata_from_hf(Tokenizer.from_file(str(src / "tokenizer.json")))
        im = load_imatrix(args.imatrix) if args.imatrix else None
        convert_hf_to_gguf(sd, cfg, args.output, quant=t, tokenizer_metadata=tok_md,
                           imatrix=im, device=dev)
    print(f"wrote {args.output}")
    return 0


def cmd_uqff_inspect(args) -> int:
    """Print a UQFF file's inventory (ours or mistral.rs v1.x)."""
    import json

    from .uqff import inspect

    print(json.dumps(inspect(args.path), indent=2))
    return 0


def cmd_perplexity(args) -> int:
    """Perplexity over a text file, for the model and each ISQ type."""
    import json

    import torch

    from .perplexity import compute_perplexity
    from .pipeline import load_pipeline

    compute_dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[args.dtype]
    results = {}
    quants = [None] + [q for q in (args.compare_isq or "").split(",") if q]
    with open(args.text) as f:
        text = f.read()
    for q in quants:
        pipe = load_pipeline(args.model, isq=q, dtype=compute_dtype, device=args.device)
        _refuse_adapter(pipe, "perplexity")
        if pipe.tokenizer is None:
            print("error: model has no tokenizer", file=sys.stderr)
            return 1
        ids = pipe.tokenizer.encode(text)
        if args.max_tokens:
            ids = ids[: args.max_tokens]
        r = compute_perplexity(pipe.weights, pipe.cfg, ids, window=args.window,
                               batch_size=args.batch_size, compute_dtype=compute_dtype,
                               progress=not args.quiet, device=args.device)
        label = q or "base"
        results[label] = r
        line = {"model": pipe.model_id, "quant": label, **r}
        if q is not None:
            line["delta_ppl"] = r["ppl"] - results["base"]["ppl"]
        print(json.dumps({k: round(v, 6) if isinstance(v, float) else v
                          for k, v in line.items()}), flush=True)
        del pipe
        if args.device != "cpu":
            torch.cuda.empty_cache()  # the next quant's load reuses this model's memory
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="mistralrs_tpu_torch", description="quantized LLM serving on one CUDA GPU"
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("serve", help="OpenAI-compatible HTTP server")
    p.add_argument("model", help="a .gguf file (llama, mistral, qwen2, qwen3, qwen3moe), a "
                                 ".uqff file, or a llama- or DeepSeek-family HF directory")
    p.add_argument("--from-uqff", default=None,
                   help="overlay a mistral.rs UQFF file onto the HF checkpoint")
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

    p = sub.add_parser("imatrix", help="collect an importance matrix (calibration)")
    p.add_argument("model", help="llama-family HF model directory")
    p.add_argument("--text", required=True, help="calibration text file (one prompt per line)")
    p.add_argument("--chunk", type=int, default=512, help="max tokens per line")
    p.add_argument("-o", "--output", required=True, help="output .npz")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_imatrix)

    p = sub.add_parser("perplexity", help="sliding-window perplexity (quality check)")
    p.add_argument("model", help="model path (.gguf or llama-family HF dir)")
    p.add_argument("text", help="evaluation text file")
    p.add_argument("--window", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-tokens", type=int, default=0, help="limit eval tokens")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--compare-isq", default="",
                   help="comma list of ISQ types to also evaluate (prints delta_ppl vs base)")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_perplexity)

    p = sub.add_parser("quantize", help="HF safetensors → quantized GGUF (or mistral.rs UQFF)")
    p.add_argument("model", help="HF model directory")
    p.add_argument("--quant", default="q4k")
    p.add_argument("--imatrix", help="imatrix .npz from the `imatrix` command")
    p.add_argument("-o", "--output", required=True, help="output .gguf or .uqff")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_quantize)

    p = sub.add_parser("uqff-inspect", help="list a UQFF file's contents")
    p.add_argument("path")
    p.set_defaults(fn=cmd_uqff_inspect)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
