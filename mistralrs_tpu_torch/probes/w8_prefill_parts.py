"""The W8 prefill body's design choices and where its time goes, on the card:

    python3 -m mistralrs_tpu_torch.probes.w8_prefill_parts

Builds ``csrc/w8_prefill.cu`` alone, as it is and in variants with some of
its parts left out (the producers' global loads, the consumers'
dequantization, the wgmma), each into its own library under ``_build/``
(all built together), and times the body with CUDA events over back-to-back launches (cold
weights: each launch takes the next of enough copies to pass 2x the L2
cache):

- Mixtral-8x7B's Q6_K down bank (8 experts, N=4096, K=14336) at n*k = 1024
  (a 512-token prefill, 64-row tiles) with blocks of one 64-row tile and
  with blocks of a pair of one expert's tiles (128 rows), the choice behind
  ``W8_GROUPED_PREFILL_TILE``;
- Mixtral's Q8_0 ``attn_v`` (N=1024, K=4096) at M = 512 in 64- and 128-row
  tiles at several K split counts, beside the count ``w8_plan`` picks;
- a Q6_K-style down projection (N=4096, K=14336) at M = 512, the same way.

A variant without a part computes garbage; only its time means anything.
Prints one line per measurement and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys

import torch

from ..ops import _cuda
from ..ops.moe_grouped import build_groups
from ..ops.quant_matmul import w8_plan
from ..quant.qtensor import QTensor
from .w4_prefill_parts import build, events_ms

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGS = [_P] * 7 + [_I] * 8 + [_L, _L, _P, _P, _P]  # mrt_w8_prefill

NO_LOADS = [("jj < BM * 8 / P8_PRODUCERS;", "jj < 0;"),
            ("jj < P8_STEP * 16 / P8_PRODUCERS;", "jj < 0;"),
            ("jj < L::GROUPS * 64 / P8_PRODUCERS;", "jj < 0;")]
NO_DEQUANT = [("          w8_frag<FMT, HB>(cw[t][kh][0], cw[t][kh][1], s2, b2, cur[t]);",
               "          cur[t][0] = cw[t][kh][0]; cur[t][1] = cw[t][kh][1];\n"
               "          cur[t][2] = cw[t][kh][0]; cur[t][3] = cw[t][kh][1];")]
NO_MMA = [("        wgmma_rs<BM>(acc[0], cur[0], db);\n        wgmma_rs<BM>(acc[1], cur[1], db);",
           "        if (db == 1) wgmma_rs<BM>(acc[0], cur[0], db);")]
VARIANTS = {
    "full": [],
    "no loads": NO_LOADS,
    "no dequant": NO_DEQUANT,
    "no wgmma": NO_MMA,
    "dequant only": NO_LOADS + NO_MMA,
    "wgmma only": NO_LOADS + NO_DEQUANT,
    "loads only": NO_DEQUANT + NO_MMA,
}


def q8(n: int, k: int, gen, dev, gs: int, lo: int, hi: int, e=None) -> QTensor:
    lead = () if e is None else (e,)
    data = torch.randint(lo, hi + 1, (*lead, k, n), generator=gen, device=dev, dtype=torch.int8)
    scale = (0.75 + 0.5 * torch.rand((*lead, k // gs, n), generator=gen, device=dev)
             ) / math.sqrt(k * (hi - lo) ** 2 / 12)
    return QTensor(data, scale, None, group_size=gs, packed=False, code_bits=8)


def copies(qt: QTensor) -> list:
    """``qt`` and enough clones that cycling through them passes 2x L2."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    extra = max(0, math.ceil(2 * l2 / qt.nbytes) - 1)
    return [qt] + [QTensor(qt.data.clone(), qt.scale.clone(), None, group_size=qt.group_size,
                           packed=False, code_bits=8) for _ in range(extra)]


class Runner:
    """Back-to-back launches of one library's prefill body."""

    def __init__(self, lib, dev):
        self.lib, self.dev = lib, dev
        self.ws = torch.empty(64 << 20, device=dev, dtype=torch.float32)
        self.cnt = torch.zeros(4096, device=dev, dtype=torch.int32)

    def launch(self, x, qt, out, tile, splits=1, tiles=None, n_used=None):
        m, k = x.shape
        bank = qt.num_banks is not None
        code = self.lib.mrt_w8_prefill(
            x.data_ptr(), qt.data.data_ptr(), qt.scale.data_ptr(), None, out.data_ptr(),
            None if tiles is None else tiles.data_ptr(),
            None if n_used is None else n_used.data_ptr(), m, out.shape[1], k, qt.group_size,
            2, 1, tile, splits, qt.data[0].numel() if bank else 0,
            qt.scale[0].numel() if bank else 0, self.ws.data_ptr(), self.cnt.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")

    def time(self, x, qts, out, tile, splits=1, tiles=None, n_used=None) -> float:
        nxt = iter(qts * 1000).__next__
        return events_ms(lambda: self.launch(x, nxt(), out, tile, splits, tiles, n_used))


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("w8_prefill_parts: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    libs = build(VARIANTS, "w8_prefill.cu", "mrt_w8_prefill", ARGS)
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # Mixtral's Q6_K down bank at n*k = 1024: 512 tokens, top-2 of 8
    bank = q8(4096, 14336, gen, dev, 16, -32, 31, e=8)
    first = torch.randint(0, 8, (512,), generator=gen, device=dev)
    topi = torch.stack([first, (first + torch.randint(1, 8, (512,), generator=gen,
                                                      device=dev)) % 8], 1)
    st, dest, _, tiles, n_used, mp = build_groups(topi, torch.rand((512, 2), device=dev), 8, 64)
    xs = torch.zeros((mp, 14336), device=dev, dtype=torch.bfloat16)
    xs[dest] = torch.randn((512, 14336), generator=gen, device=dev).to(torch.bfloat16)[st]
    gout = torch.empty((mp, 4096), device=dev, dtype=torch.bfloat16)
    print(f"grouped Q6_K down n*k=1024: {int(n_used)} used tiles of 64 rows", flush=True)
    for name, lib in libs.items():
        r = Runner(lib, dev)
        t64 = r.time(xs, [bank], gout, 64, 1, tiles, n_used)
        t128 = r.time(xs, [bank], gout, 128, 1, tiles, n_used)
        print(f"{name:14s} grouped Q6_K down n*k=1024: 64-row blocks {t64:.4f} ms, "
              f"128-row blocks (pairs) {t128:.4f} ms [{card}]", flush=True)
    del bank, xs, gout
    full = Runner(libs["full"], dev)
    for what, n, k, gs, lo, hi in (("attn_v Q8_0", 1024, 4096, 32, -127, 127),
                                   ("Q6_K-style down", 4096, 14336, 16, -32, 31)):
        qts = copies(q8(n, k, gen, dev, gs, lo, hi))
        x = torch.randn((512, k), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((512, n), device=dev, dtype=torch.bfloat16)
        plan = w8_plan(512, n, k, sms, None, gs)
        for tile in (64, 128):
            cells = []
            for splits in sorted({1, 2, 4, 5, 8, 16, plan.splits}):
                t = full.time(x, qts, out, tile, splits)
                cells.append(f"{splits} splits {t:.4f}")
            print(f"{what} M=512 N={n} K={k}, {tile}-row tiles: " + ", ".join(cells)
                  + f" ms (plan: {plan.tile} rows, {plan.splits} splits) [{card}]", flush=True)
        for name in ("no loads", "no dequant", "no wgmma", "dequant only", "wgmma only"):
            t = Runner(libs[name], dev).time(x, qts, out, plan.tile, plan.splits)
            print(f"{name:14s} {what} M=512 at the plan's tile and splits: {t:.4f} ms",
                  flush=True)
        del qts, x, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
