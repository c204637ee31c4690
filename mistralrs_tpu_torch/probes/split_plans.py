"""The split plans of the paged decode and MLA decode kernels against their
alternatives, on the card:

    python3 -m mistralrs_tpu_torch.probes.split_plans

Times the device's own kernel time per call (a ``torch.profiler`` trace of
10 calls, so the host's launch time stays out) of the paged decode kernel
(``csrc/paged_attention.cu``, the port's own build) at several split sizes,
beside the plan ``decode_plan`` picks: 8 rows of 32/8 heads with kv_lens up
to 1024 (tables of 16 blocks of 64), one row at 8192 positions and 8 rows
at 4096. Then the MLA decode kernel (``csrc/mla_attention.cu``) at 4 to 256
splits (blocks per sequence, in clusters of at most 16, and of 8) beside
the plan ``mla_plan`` picks, at
DeepSeek-V2-Lite's head shapes (16 heads, rows of 576, rank 512, blocks of
64): ``mla_rows`` (8 rows with kv_lens 0-2048 in tables of 32 blocks, one
row at 8192 positions, 8 rows at 4096, and a serve step: 6 rows of ~100
positions and 2 empty ones in tables of 32 blocks).

Prints one line per shape and the card's name and power limit.
"""

from __future__ import annotations

import math
import subprocess
import sys

import torch

from ..ops.mla_attention import MLA_TILE, MlaPlan, _mla_cuda, clustered, mla_blocks, mla_plan
from ..ops.paged_attention import DecodePlan, _decode_cuda, decode_plan

# (what, kv_lens, table width in blocks of 64)
MLA_ROWS = (("B=8 kv_lens 0-2048", (1, 2048, 700, 0, 65, 1333, 64, 1024), 32),
            ("B=1 at 8192", (8192,), 128), ("B=8 at 4096", (4096,) * 8, 64),
            ("serve step B=8 kv_lens ~100", (101, 97, 116, 100, 108, 99, 0, 0), 32))


def device_ms(fn, iters: int = 10) -> float:
    """The device's kernel time per call of ``fn`` (all its kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def decode_rows(card: str, gen, dev, sms: int) -> None:
    n_q, n_kv, hd, bs = 32, 8, 128, 64
    for what, lens, w in (("B=8 kv_lens<=1024", (1024, 1, 700, 64, 65, 333, 901, 512), 16),
                          ("B=1 at 8192", (8192,), 128), ("B=8 at 4096", (4096,) * 8, 64)):
        b = len(lens)
        kv_lens = torch.tensor(lens, device=dev, dtype=torch.int32)
        bt = torch.randperm(b * w, generator=gen, device=dev).to(torch.int32).reshape(b, w)
        s_total = (b * w + 1) * bs
        kp = torch.randn((n_kv, s_total, hd), generator=gen, device=dev).to(torch.bfloat16)
        vp = torch.randn_like(kp)
        q = torch.randn((b, n_q, hd), generator=gen, device=dev).to(torch.bfloat16)
        kn = torch.randn((b, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
        slots = torch.full((b,), -1, device=dev, dtype=torch.int32)
        tiles = w * bs // 64
        pick = decode_plan(b, n_kv, n_q // n_kv, w, bs, sms)
        cells = []
        for per in sorted({1, 2, 3, 4, 6, 11, 22, tiles, pick.positions // 64}):
            if per > tiles:
                continue
            forced = DecodePlan(64 * per, -(-tiles // per))
            t = device_ms(lambda: _decode_cuda(q, kp, vp, kn, kn, slots, bt, kv_lens, bs,
                                               1 / math.sqrt(hd), plan=forced))
            cells.append(f"{64 * per}x{forced.splits} {t:.4f}")
        print(f"paged decode {what}, positions x splits: " + ", ".join(cells)
              + f" ms (plan: {pick.positions}x{pick.splits}) [{card}]", flush=True)
        del kp, vp


def mla_rows(gen, dev, nh=16, d=576, bs=64):
    """Yields ``(what, args)`` per row of ``MLA_ROWS``: the arguments of
    ``_mla_cuda`` (rank 512, every write dropped into the trash row)."""
    for what, lens, w in MLA_ROWS:
        b = len(lens)
        bt = torch.randperm(b * w, generator=gen, device=dev).to(torch.int32).reshape(b, w)
        pool = torch.randn(((b * w + 1) * bs, d), generator=gen, device=dev).to(torch.bfloat16)
        q = torch.randn((b, nh, d), generator=gen, device=dev).to(torch.bfloat16)
        rows = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
        slots = torch.full((b,), -1, device=dev, dtype=torch.int32)
        kv_lens = torch.tensor(lens, device=dev, dtype=torch.int32)
        yield what, (q, pool, rows, slots, bt, kv_lens, bs, 512, 192 ** -0.5)
        del pool


def mla_plans(card: str, gen, dev, sms: int) -> None:
    for what, args in mla_rows(gen, dev):
        b, nh = args[0].shape[:2]
        w, bs = args[4].shape[1], args[6]
        tiles = w * bs // MLA_TILE
        pick = mla_plan(b, mla_blocks(nh, args[7]), w, bs, sms)
        cells = []
        plans = {clustered(s) for s in (4, 8, 16, 24, 28, 32, 64, 128, 256, pick.splits)}
        plans |= {MlaPlan(s, 8) for s in (16, 24, 32, 48, 64)}  # clusters of 8
        for forced in sorted(plans):
            if forced.splits > tiles:
                continue
            t = device_ms(lambda: _mla_cuda(*args, plan=forced))
            cells.append(f"{forced.splits}/{forced.cluster} {t:.4f}")
        print(f"mla decode {what}, splits/cluster: " + ", ".join(cells)
              + f" ms (plan: {pick.splits}/{pick.cluster}) [{card}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("split_plans: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    decode_rows(card, gen, dev, sms)
    mla_plans(card, gen, dev, sms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
