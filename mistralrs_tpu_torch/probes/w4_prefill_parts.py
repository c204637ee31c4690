"""Where the W4 prefill body's time goes, part by part, on the card:

    python3 -m mistralrs_tpu_torch.probes.w4_prefill_parts

Builds variants of ``csrc/w4_matmul.cu`` with some of its parts left out
(the producers' global loads, the consumers' dequantization, the wgmma), or
with the dequantization moved after the wgmma's wait (no overlap), each into
its own library under ``_build/`` (all built together), and times the prefill body with CUDA
events over 20 back-to-back launches: Llama-3-8B's gate-up at M = 512 (the
128-row tile), the same at the 64-row tile, and Mixtral-8x7B's fused gate/up
bank at n*k = 1024 (grouped, 64-row tiles). A variant without a part
computes garbage; only its time means anything. Prints one line per variant
and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys

import torch

from ..ops import _cuda
from ..ops.moe_grouped import build_groups
from ..quant.qtensor import QTensor

NO_LOADS = [("for (int i = p; i < 8 * L::BM; i += P_PRODUCERS)",
             "for (int i = p; i < 0; i += P_PRODUCERS)"),
            ("for (int i = p; i < 32 * 16; i += P_PRODUCERS)",
             "for (int i = p; i < 0; i += P_PRODUCERS)"),
            ("for (int i = p; i < 2 * SUB * 64; i += P_PRODUCERS)",
             "for (int i = p; i < 0; i += P_PRODUCERS)")]
NO_DEQUANT = [("      dequant(ns, buf ^ 1);\n", "")]
NO_MMA = [("      wgmma_tile<WN>(acc, sw128_desc", "      if (0) wgmma_tile<WN>(acc, sw128_desc")]
SERIAL = [("""    wgmma_commit();
    if (s + 1 < nsteps) {
      const int ns = (s + 1) % L::STAGES;
      mbar_wait(full + 8 * ns, ((s + 1) / L::STAGES) & 1);
      fence_proxy_async();
      dequant(ns, buf ^ 1);
      fence_proxy_async();
    }
    wgmma_wait0();""", """    wgmma_commit();
    wgmma_wait0();
    if (s + 1 < nsteps) {
      const int ns = (s + 1) % L::STAGES;
      mbar_wait(full + 8 * ns, ((s + 1) / L::STAGES) & 1);
      fence_proxy_async();
      dequant(ns, buf ^ 1);
      fence_proxy_async();
    }""")]
VARIANTS = {
    "full": [],
    "no loads": NO_LOADS,
    "no dequant": NO_DEQUANT,
    "no wgmma": NO_MMA,
    "dequant only": NO_LOADS + NO_MMA,
    "wgmma only": NO_LOADS + NO_DEQUANT,
    "loads only": NO_DEQUANT + NO_MMA,
    "dequant after wgmma wait": SERIAL,
}


def build(variants: dict, source: str = "w4_matmul.cu", entry: str = "mrt_w4_matmul",
          argtypes=None, csrc=None, prefix: str = "", suffix: str = "") -> dict:
    """``{name: library}``: ``source`` (in ``csrc``, by default the port's
    ``csrc/``) with each variant's edits (old, new) applied, between
    ``prefix`` and ``suffix``, built alone into its own library under
    ``_build/`` (one ``nvcc`` per variant, all started together); ``entry``
    bound with ``argtypes`` (by default its signature in ``_cuda``)."""
    csrc = csrc or _cuda.CSRC
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        src = (csrc / source).read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {name!r}: the source no longer has {old[:60]!r}")
            src = src.replace(old, new)
        src = prefix + src + suffix
        tag = f"{source.split('.')[0]}_{name.replace(' ', '_')}"
        path = _cuda.BUILD_DIR / f"parts_{tag}.cu"
        path.write_text(src)
        lib = _cuda.BUILD_DIR / f"libparts_{tag}.so"
        procs[name] = (lib, subprocess.Popen(
            [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", str(csrc), "-shared", "-o",
             str(lib), str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r}: nvcc failed\n{log[-2000:]}")
        cdll = ctypes.CDLL(str(lib))
        fn = getattr(cdll, entry)
        fn.argtypes = argtypes or _cuda._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        libs[name] = cdll
    return libs


def q4k(n: int, k: int, gen, dev, e=None) -> QTensor:
    lead = () if e is None else (e,)
    data = torch.randint(0, 256, (*lead, k // 2, n), generator=gen, device=dev,
                         dtype=torch.uint8)
    scale = (0.75 + 0.5 * torch.rand((*lead, k // 32, n), generator=gen, device=dev)
             ) / math.sqrt(21.25 * k)
    return QTensor(data, scale, -8.0 * scale, group_size=32, packed=True, code_bits=4)


def launch(lib, x, qt, out, tile, tiles=None, n_used=None) -> None:
    m, k = x.shape
    bank = qt.num_banks is not None
    sh, ssh = qt.data.shape, qt.scale.shape
    code = lib.mrt_w4_matmul(
        x.data_ptr(), qt.data.data_ptr(), qt.scale.data_ptr(), qt.bias.data_ptr(),
        out.data_ptr(), None if tiles is None else tiles.data_ptr(),
        None if n_used is None else n_used.data_ptr(), m, out.shape[1], k, 1, 1, tile, 1,
        sh[-2] * sh[-1] if bank else 0, ssh[-2] * ssh[-1] if bank else 0, None, None,
        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"launch failed: CUDA error {code}")


def events_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("w4_prefill_parts: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    libs = build(VARIANTS)
    qt = q4k(28672, 4096, gen, dev)
    x = torch.randn((512, 4096), generator=gen, device=dev).to(torch.bfloat16)
    out = torch.empty((512, 28672), device=dev, dtype=torch.bfloat16)
    bank = q4k(28672, 4096, gen, dev, e=8)
    first = torch.randint(0, 8, (512,), generator=gen, device=dev)
    topi = torch.stack([first, (first + torch.randint(1, 8, (512,), generator=gen,
                                                      device=dev)) % 8], 1)
    st, dest, _, tiles, n_used, mp = build_groups(topi, torch.rand((512, 2), device=dev), 8, 64)
    xs = torch.zeros((mp, 4096), device=dev, dtype=torch.bfloat16)
    xs[dest] = torch.randn((512, 4096), generator=gen, device=dev).to(torch.bfloat16)[st]
    gout = torch.empty((mp, 28672), device=dev, dtype=torch.bfloat16)
    print(card)
    for name, lib in libs.items():
        t128 = events_ms(lambda: launch(lib, x, qt, out, 128))
        t64 = events_ms(lambda: launch(lib, x, qt, out, 64))
        tg = events_ms(lambda: launch(lib, xs, bank, gout, 64, tiles, n_used), iters=5)
        print(f"{name:26s} M=512 gate-up 128-row tile {t128:.4f} ms, 64-row tile {t64:.4f} ms; "
              f"grouped gate/up n*k=1024 {tg:.4f} ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
