"""The paged decode kernel's split plan against its alternatives, on the
card:

    python3 -m mistralrs_tpu_torch.probes.split_plans

Times the device's own kernel time per call (a ``torch.profiler`` trace of
10 calls, so the host's launch time stays out) of the paged decode kernel
(``csrc/paged_attention.cu``, the port's own build) at several split sizes,
beside the plan ``decode_plan`` picks: 8 rows of 32/8 heads with kv_lens up
to 1024 (tables of 16 blocks of 64), one row at 8192 positions and 8 rows
at 4096.

Prints one line per shape and the card's name and power limit.
"""

from __future__ import annotations

import math
import subprocess
import sys

import torch

from ..ops.paged_attention import DecodePlan, _decode_cuda, decode_plan


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
    return 0


if __name__ == "__main__":
    sys.exit(main())
