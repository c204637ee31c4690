"""The quantized (int8) forms of the paged decode and prefill kernels by
parts, on the card:

    python3 -m mistralrs_tpu_torch.probes.quant_attention_parts

Builds the kernels' bodies (``csrc/paged_attention.cuh``) with their entry
points (``csrc/paged_attention.cu``) at head_dim 128 alone, as they are and
in variants (all built together, each into its own library under
``_build/``): the prefill
form without its first launch (the chunk's rows quantized, written and
round-tripped once), without the widening of the past's codes, without
the whole pass over the landed tile (and its second barrier), and with the
thread's row and chunk in the copies (``tid / CPR``, ``tid % CPR``)
divided as signed ``int`` inside the per-tile copy code, as an earlier
form of the source did (the source divides them once, as unsigned); the
decode form without its pass over the landed tile.
Times each (the device's kernel time per call, ``probes/split_plans.py``'s
profiler measure) beside the bf16 forms of the same library at the same
shapes: prefill at B=2 T=128 on 300 cached positions and 512 tokens on 512,
decode at B=8 with kv_lens up to 1024 and at 8 x 4096 (Llama-3-8B's 32/8
heads, blocks of 64).

A variant without a part computes garbage; only its time means anything.
Prints one line per shape and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from ..kv.paged import quantize_rows
from ..ops import _cuda
from ..ops.paged_attention import paged_decode_attention_fused, paged_prefill_attention_fused
from .split_plans import device_ms
from .w4_prefill_parts import build

NO_CHUNK_PASS = [("quant_chunk_kernel<Q == 2, D><<<dim3((T * n_kv + 1) / 2, B), THREADS, 0, st>>>(",
                  "if (0) quant_chunk_kernel<Q == 2, D><<<dim3((T * n_kv + 1) / 2, B), THREADS, "
                  "0, st>>>(")]
NO_WIDEN = [("        widen_row<FP8, D>(st + L::QC + kv * L::QC_KV_B, wide, r, lane);\n", "")]
NO_PASS = [("""      widen(it % FA_STAGES, p0);
      __syncthreads();  // the widened tile and its scales, for every warp
""", "")]
NO_DECODE_PASS = [("""      widen(it % DC_STAGES, p_begin + it * FA_TILE);
      __syncthreads();  // the widened tile and its scales, for every warp
""", "")]
SIGNED_DIVISION = [("    const int c = tc;\n", "    const int c = tid % CPR;\n"),
                   ("      const int r = tr + RPP * j, p = p0 + r;",
                    "      const int r = tid / CPR + RPP * j, p = p0 + r;")]
VARIANTS = {
    "full": [],
    "prefill no chunk launch": NO_CHUNK_PASS,
    "prefill no widening": NO_WIDEN,
    "prefill no pass": NO_PASS,
    "prefill signed division": SIGNED_DIVISION,
    "decode no pass": NO_DECODE_PASS,
}
ENTRIES = ("mrt_paged_decode", "mrt_paged_decode_q", "mrt_paged_prefill", "mrt_paged_prefill_q")


def pools(gen, n_kv, s_total, hd, dev):
    """bf16 pools and int8 pools of the same rows, with their scales."""
    out = []
    for _ in range(2):
        rows = torch.randn((n_kv, s_total, hd), generator=gen, device=dev).to(torch.bfloat16)
        codes, s = quantize_rows(rows, torch.int8)
        out.append((rows, codes, s.to(torch.bfloat16)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("quant_attention_parts: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    # one source: the edited bodies, then the entry points with only head_dim
    # 128's forms (the header's include guard skips their include of it)
    libs = build(VARIANTS, "paged_attention.cuh", ENTRIES[0],
                 prefix="#define PA_HEAD_DIMS(X) X(128)\n",
                 suffix="\n" + (_cuda.CSRC / "paged_attention.cu").read_text())
    for lib in libs.values():  # bind the other entries too
        for name in ENTRIES[1:]:
            fn = getattr(lib, name)
            fn.argtypes = _cuda._SIGNATURES[name]
            fn.restype = ctypes.c_int
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_q, n_kv, hd, bs = 32, 8, 128, 64

    def timed(label, bf16_call, q8_call, names):
        cells = []
        for name in names:
            _cuda._lib = libs[name]
            try:
                if name == "full":
                    cells.append(f"bf16 form {device_ms(bf16_call):.4f}")
                cells.append(f"int8 {name} {device_ms(q8_call):.4f}")
            finally:
                _cuda._lib = None
        print(f"{label}: " + ", ".join(cells) + f" ms [{card}]", flush=True)

    prefill_names = [n for n in VARIANTS if not n.startswith("decode")]
    for b, t, nv, past in ((2, 128, (128, 70), (300, 300)), (1, 512, (512,), (512,))):
        n_valid = torch.tensor(nv, device=dev, dtype=torch.int32)
        kv_lens = n_valid + torch.tensor(past, device=dev, dtype=torch.int32)
        w = -(-(max(past) + t) // bs)
        bt = torch.randperm(b * w, generator=gen, device=dev).to(torch.int32).reshape(b, w)
        (kb, kc, ks), (vb, vc, vs) = pools(gen, n_kv, (b * w + 1) * bs, hd, dev)
        q = torch.randn((b, t, n_q, hd), generator=gen, device=dev).to(torch.bfloat16)
        kn = torch.randn((b, t, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
        vn = torch.randn_like(kn)
        tok = torch.arange(t, device=dev)[None]
        pos = (kv_lens - n_valid)[:, None] + tok
        slots = (bt.gather(1, (pos // bs).clamp_max(w - 1).long()) * bs + pos % bs).to(torch.int32)
        slots[tok.expand(b, t) >= n_valid[:, None]] = -1
        args = (kn, vn, slots, bt, kv_lens, n_valid)
        timed(f"prefill B={b} T={t} on {past[0]}",
              lambda: paged_prefill_attention_fused(q, kb, vb, *args, block_size=bs),
              lambda: paged_prefill_attention_fused(q, kc, vc, *args, block_size=bs,
                                                    k_scale=ks, v_scale=vs), prefill_names)
    for what, lens, w in (("B=8 kv_lens<=1024", (1024, 1, 700, 64, 65, 333, 901, 512), 16),
                          ("B=8 at 4096", (4096,) * 8, 64)):
        b = len(lens)
        kv_lens = torch.tensor(lens, device=dev, dtype=torch.int32)
        bt = torch.randperm(b * w, generator=gen, device=dev).to(torch.int32).reshape(b, w)
        (kb, kc, ks), (vb, vc, vs) = pools(gen, n_kv, (b * w + 1) * bs, hd, dev)
        q = torch.randn((b, n_q, hd), generator=gen, device=dev).to(torch.bfloat16)
        kn = torch.randn((b, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
        slots = (bt.gather(1, ((kv_lens - 1) // bs)[:, None].long())[:, 0] * bs
                 + (kv_lens - 1) % bs).to(torch.int32)
        args = (kn, kn, slots, bt, kv_lens)
        timed(f"decode {what}",
              lambda: paged_decode_attention_fused(q, kb, vb, *args, block_size=bs),
              lambda: paged_decode_attention_fused(q, kc, vc, *args, block_size=bs,
                                                   k_scale=ks, v_scale=vs),
              ["full", "decode no pass"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
