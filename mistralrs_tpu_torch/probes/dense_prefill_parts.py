"""The dense grouped kernel's prefill body by parts, on the card:

    python3 -m mistralrs_tpu_torch.probes.dense_prefill_parts

Builds ``csrc/dense_grouped.cu`` alone, as it is and in variants (all built
together, each into its own library under ``_build/``): without the
producers' global loads, without the wgmma, with two producer warps in place
of the producer warpgroup, and with 128-column blocks and a 6-stage ring in
place of 256 columns and 4 stages. Times each (the device's kernel time per
call, ``probes/split_plans.py``'s profiler measure) on 64-row tiles:
Mixtral-8x7B's bf16 down bank (8 experts, N=4096, K=14336) at n*k = 1024
(512 tokens, top-2) and DeepSeek-V2-Lite's gate/up (64 experts, N=2816,
K=2048) and down (N=2048, K=1408) banks at n*k = 1152 (192 tokens, top-6).

A variant without a part computes garbage; only its time means anything.
Prints one line per bank and the card's name and power limit.
"""

from __future__ import annotations

import math
import subprocess
import sys

import torch

from ..ops import _cuda
from ..ops.moe_grouped import build_groups, dense_matmul_grouped
from .split_plans import device_ms
from .w4_prefill_parts import build

NO_LOADS = [("jj < DP_BN * 8 / DP_PRODUCERS;", "jj < 0;"), ("j < rows * 8;", "j < 0;")]
NO_WGMMA = [("        wgmma_kk<R>(acc[t],", "        if (db == 1) wgmma_kk<R>(acc[t],")]
TWO_PRODUCER_WARPS = [("constexpr int DP_PRODUCERS = 128;", "constexpr int DP_PRODUCERS = 64;")]
COLUMNS_128 = [("constexpr int DP_BN = 256;", "constexpr int DP_BN = 128;"),
               ("constexpr int DP_STAGES = 4;", "constexpr int DP_STAGES = 6;")]
VARIANTS = {
    "full": [],
    "no loads": NO_LOADS,
    "no wgmma": NO_WGMMA,
    "two producer warps": TWO_PRODUCER_WARPS,
    "128 columns 6 stages": COLUMNS_128,
}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("dense_prefill_parts: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    libs = build(VARIANTS, "dense_grouped.cu", "mrt_dense_matmul_grouped")
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for what, e, n, k, ntok, top in (("Mixtral bf16 down n*k=1024", 8, 4096, 14336, 512, 2),
                                     ("V2-Lite gate/up n*k=1152", 64, 2816, 2048, 192, 6),
                                     ("V2-Lite down n*k=1152", 64, 2048, 1408, 192, 6)):
        bank = (torch.randn((e, n, k), generator=gen, device=dev) / math.sqrt(k)).to(
            torch.bfloat16)
        topi = torch.rand((ntok, e), generator=gen, device=dev).argsort(dim=1)[:, :top]
        st, dest, _, tiles, n_used, mp = build_groups(
            topi, torch.rand((ntok, top), generator=gen, device=dev), e, 64)
        xs = torch.zeros((mp, k), device=dev, dtype=torch.bfloat16)
        xs[dest] = torch.randn((ntok, k), generator=gen, device=dev).to(torch.bfloat16)[st]
        cells = []
        for name, lib in libs.items():
            _cuda._lib = lib
            try:
                t = device_ms(lambda: dense_matmul_grouped(xs, bank, tiles, tm=64,
                                                           n_used_tiles=n_used))
            finally:
                _cuda._lib = None
            cells.append(f"{name} {t:.4f}")
        print(f"dense grouped prefill {what} ({int(n_used)} used tiles of 64 rows): "
              + ", ".join(cells) + f" ms [{card}]", flush=True)
        del bank, xs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
