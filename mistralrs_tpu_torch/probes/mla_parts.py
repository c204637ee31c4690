"""Where the MLA decode kernel's time goes, part by part, on the card:

    python3 -m mistralrs_tpu_torch.probes.mla_parts [--old DIR]

Builds ``csrc/mla_attention.cu`` alone, as it is and in variants (all built
together, each into its own library under ``_build/``): without the tile
copies (compute only: the block-table lookups, Q, the products, the softmax
and the merges stay), without the tensor-core products (loads only: the
copies, the score exchange, the softmax and the merges stay), without the
merges (every block writes out as if it were a sequence's only split), as
a skeleton (no copies, products or merges: the launch, the query load, the
table lookups, the score exchange and the softmax), with 8 warps a block
in place of 4, and with 3 ring stages in place of 2 (one block per SM). With ``--old DIR``, the
``csrc`` directory of a tree whose MLA kernel is the earlier wmma one (a
split kernel and a combine kernel), also that source as it is, without its
tile fill, and without its wmma products, launched at that kernel's own
split rule (``old_splits``). Times each (the device's kernel time per call,
``probes/split_plans.py``'s profiler measure) at ``split_plans.MLA_ROWS``.
Then a timeline: a build that records each working block's SM and the start
and end of its walk, per row, and the card's count of co-resident clusters
of 1-16 blocks at the kernel's shared memory.

A variant without a part computes garbage; only its time means anything.
Prints one line per row and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _cuda
from ..ops.mla_attention import _mla_cuda
from ..ops.paged_attention import LOG2E
from .split_plans import device_ms, mla_rows
from .w4_prefill_parts import build

# no tile rows copied, counted or zero-filled (the queries still are)
NO_COPIES = [("min(TILE, kv_len - tile_pos(i)) * row_bytes);", "0);"),
             ("      if (ent >= 0) {\n        const int r = RW * warp + lane;",
              "      if (false) {\n        const int r = RW * warp + lane;"),
             ("      zero_rows(base, none << (RW * warp));\n", "")]
NO_S = [("      if (kb < ke) load_s(kb, fa, fb);\n      for (int kc = kb; kc < ke; kc += 2) {",
         "      for (int kc = kb; kc < kb; kc += 2) {")]
NO_PV = [("          if (2 * jp < wnt)\n            ldsm_x4_trans",
          "          if (2 * jp < 0)\n            ldsm_x4_trans"),
         ("          if (2 * jp < wnt) {\n            mma_bf16(o[2 * jp]",
          "          if (2 * jp < 0) {\n            mma_bf16(o[2 * jp]")]
NO_MERGE = [("  if (live <= 1) {\n#pragma unroll", "  if (true) {\n#pragma unroll")]
VARIANTS = {
    "full": [],
    "compute only": NO_COPIES,
    "loads only": NO_S + NO_PV,
    "no merge": NO_MERGE,
    "skeleton": NO_COPIES + NO_S + NO_PV + NO_MERGE,
    "8 warps": [("constexpr int THREADS = 128;", "constexpr int THREADS = 256;")],
    "3 stages": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
}

# each working block's start and end of its walk (%globaltimer, ns), its SM
# and its tiles, into a device array read back by mrt_timeline; and the
# card's count of co-resident clusters of each size at this launch's shape
TIMELINE = [
    ("  if (live <= 1 ? split > 0 : ci >= live_cl) return;  // nothing to do, nothing to merge\n",
     "  if (live <= 1 ? split > 0 : ci >= live_cl) return;  // nothing to do, nothing to merge\n"
     "  unsigned long long t_start, t_end;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_start));\n"),
    ("      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);\n    }\n",
     "      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);\n    }\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_end));\n"
     "    if (tid == 0) {\n"
     "      unsigned smid;\n"
     "      asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "      const size_t k = ((size_t)blockIdx.z * gridDim.y + b) * gridDim.x + split;\n"
     "      if (k < (1 << 16)) {\n"
     "        tl[4 * k] = t_start; tl[4 * k + 1] = t_end; tl[4 * k + 2] = smid;\n"
     "        tl[4 * k + 3] = mine;\n"
     "      }\n"
     "    }\n"),
    ("}  // namespace\n",
     "}  // namespace\n"
     "extern \"C\" int mrt_timeline(void* dst) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, tl, sizeof(tl));\n"
     "}\n"
     "extern \"C\" int mrt_timeline_clear() {\n"
     "  static unsigned long long zero[4 << 16];\n"
     "  return (int)cudaMemcpyToSymbol(tl, zero, sizeof(tl));\n"
     "}\n"
     "extern \"C\" int mrt_max_clusters(int cluster, int blocks, int d16) {\n"
     "  const Layout L = layout(d16);\n"
     "  cudaFuncSetAttribute(mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
     "                       (int)L.total);\n"
     "  cudaFuncSetAttribute(mla_decode_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
     "  cudaLaunchConfig_t cfg = {};\n"
     "  cfg.gridDim = dim3(blocks);\n"
     "  cfg.blockDim = dim3(THREADS);\n"
     "  cfg.dynamicSmemBytes = L.total;\n"
     "  cudaLaunchAttribute attr[1];\n"
     "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
     "  attr[0].val.clusterDim.x = cluster;\n"
     "  attr[0].val.clusterDim.y = 1;\n"
     "  attr[0].val.clusterDim.z = 1;\n"
     "  cfg.attrs = attr;\n"
     "  cfg.numAttrs = 1;\n"
     "  int n = -1;\n"
     "  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, mla_decode_kernel, &cfg);\n"
     "  return e == cudaSuccess ? n : -(int)e;\n"
     "}\n"),
    ("namespace {\n\nconstexpr int THREADS",
     "namespace {\n\n__device__ unsigned long long tl[4 << 16];\n"
     "__device__ unsigned long long ph[2 * 8 * 8];\n"
     "#define PH(k) if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && lane == 0 && \\\n"
     "    warp < 2 && it < 8) { unsigned long long c_; \\\n"
     "    asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(c_)); ph[(warp * 8 + it) * 8 + k] = c_; }\n"
     "\nconstexpr int THREADS"),
    # clock64 stamps of warps 0 and 1 of block (0, 0, 0), iterations 0-7:
    # entry, tile landed, past the ring barrier, past the copies' issue,
    # past the score products, past the exchange, past the softmax, past PV
    ("      mbar_wait(bar0 + 8 * (it % STAGES), (it / STAGES) & 1);  // this tile (and Q) landed\n",
     "      PH(0)\n      mbar_wait(bar0 + 8 * (it % STAGES), (it / STAGES) & 1);  // this tile (and Q) landed\n"
     "      PH(1)\n"),
    ("      __syncthreads();  // the zero rows are written; the slot refilled below is free\n",
     "      __syncthreads();  // the zero rows are written; the slot refilled below is free\n"
     "      PH(2)\n"),
    ("      pend = entry(nxt + 1);  // used after the next barrier\n",
     "      pend = entry(nxt + 1);  // used after the next barrier\n      PH(3)\n"),
    ("      // 5. the slices summed in warp order by every warp\n",
     "      PH(4)\n      // 5. the slices summed in warp order by every warp\n"),
    ("      // 6. online softmax, the running max", "      PH(5)\n      // 6. online softmax, the running max"),
    ("      // 7. O += P · rows[:, :rank] over", "      PH(6)\n      // 7. O += P · rows[:, :rank] over"),
    ("    }\n#pragma unroll\n    for (int i = 0; i < 2; ++i) {\n      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);",
     "      PH(7)\n    }\n#pragma unroll\n    for (int i = 0; i < 2; ++i) {\n      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);"),
    ("extern \"C\" int mrt_timeline_clear() {",
     "extern \"C\" int mrt_phases(void* dst) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, ph, sizeof(ph));\n"
     "}\n"
     "extern \"C\" int mrt_timeline_clear() {"),
]

OLD_VARIANTS = {
    "before full": [],
    "before no tile fill": [("    for (int i = tid; i < TILE * nch16; i += THREADS) {",
                             "    for (int i = tid; i < 0; i += THREADS) {")],
    "before loads only": [("      for (int kk = 0; kk < d16; kk += 16) {",
                           "      for (int kk = 0; kk < 0; kk += 16) {"),
                          ("    for (int nt = warp; nt < rank / 16; nt += NWARPS) {",
                           "    for (int nt = warp; nt < 0; nt += NWARPS) {")],
}


# the earlier kernel's C signature: 9 pointers, 9 ints, the scale, the stream
OLD_SIGNATURE = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]


def old_splits(b: int, nh: int, positions: int) -> tuple[int, int]:
    """The earlier kernel's ``(n_split, span)``: 64-position tiles, enough
    splits for ~264 blocks."""
    n_tiles = max(1, -(-positions // 64))
    want = max(1, -(-264 // (b * -(-nh // 16))))
    span = 64 * -(-n_tiles // min(n_tiles, want))
    return -(-n_tiles * 64 // span), span


def old_launch(lib, q, pool, rows, slots, bt, kv_lens, bs, rank, scale):
    """One launch of the earlier kernel (its o_part / ml_part scratch)."""
    b, nh, d = q.shape
    n_split, span = old_splits(b, nh, bt.shape[1] * bs)
    out = torch.empty((b, nh, rank), dtype=torch.bfloat16, device=q.device)
    o_part = torch.empty((b, n_split, nh, rank), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((b, n_split, nh, 2), dtype=torch.float32, device=q.device)
    code = lib.mrt_mla_decode(
        q.data_ptr(), pool.data_ptr(), rows.data_ptr(), slots.data_ptr(), bt.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(), o_part.data_ptr(), ml_part.data_ptr(), b, nh, d,
        rank, pool.shape[0], bt.shape[1], bs, span, n_split, float(scale * LOG2E),
        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"launch failed: CUDA error {code}")
    return out


def new_launch(lib, *args):
    """One launch of this tree's kernel through its wrapper (its plan), with
    ``lib`` as the kernel library."""
    _cuda._lib = lib
    try:
        return _mla_cuda(*args)
    finally:
        _cuda._lib = None


def timeline(card: str, gen, dev) -> None:
    """Per row: the co-resident clusters the card allows at this shape, and
    how the working blocks of one launch spread over SMs and time."""
    import numpy as np

    lib = build({"timeline": TIMELINE}, "mla_attention.cu", "mrt_mla_decode")["timeline"]
    for fn in ("mrt_timeline", "mrt_timeline_clear", "mrt_max_clusters", "mrt_phases"):
        getattr(lib, fn).restype = ctypes.c_int
    lib.mrt_timeline.argtypes = [ctypes.c_void_p]
    lib.mrt_phases.argtypes = [ctypes.c_void_p]
    lib.mrt_max_clusters.argtypes = [ctypes.c_int] * 3
    fits = {c: lib.mrt_max_clusters(c, 16 * c, 576) for c in (1, 2, 4, 8, 16)}
    print(f"co-resident clusters of 1/2/4/8/16 blocks: {fits} [{card}]", flush=True)
    for what, args in mla_rows(gen, dev):
        new_launch(lib, *args)  # warm
        torch.cuda.synchronize()
        lib.mrt_timeline_clear()
        new_launch(lib, *args)
        torch.cuda.synchronize()
        buf = np.zeros((1 << 16, 4), dtype=np.uint64)
        lib.mrt_timeline(buf.ctypes.data)
        rec = buf[buf[:, 0] > 0].astype(np.int64)
        t0 = rec[:, 0].min()
        start, end = (rec[:, 0] - t0) / 1e3, (rec[:, 1] - t0) / 1e3  # us
        walk = end - start
        per_sm = np.bincount(rec[:, 2].astype(int))
        phases = np.zeros((2, 8, 8), dtype=np.uint64)
        lib.mrt_phases(phases.ctypes.data)
        for w in range(2):
            rows = phases[w].astype(np.int64)
            used = rows[rows[:, 0] > 0]
            print(f"  block (0, 0, 0) warp {w}, cycles per iteration (wait, ring barrier, "
                  f"issue, scores, exchange, softmax, PV, to next): "
                  + "; ".join(",".join(str(int(x)) for x in np.diff(r)) + "," +
                              (str(int(used[i + 1][0] - r[7])) if i + 1 < len(used) else "-")
                              for i, r in enumerate(used)), flush=True)
        print(f"mla timeline {what}: {len(rec)} working blocks on {int((per_sm > 0).sum())} SMs "
              f"(max {per_sm.max()} a SM), starts 0-{start.max():.2f} us, walks "
              f"{walk.min():.2f}/{np.median(walk):.2f}/{walk.max():.2f} us (min/median/max) for "
              f"{rec[:, 3].min()}-{rec[:, 3].max()} tiles, last walk ends {end.max():.2f} us "
              f"[{card}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("mla_parts: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    old = Path(sys.argv[sys.argv.index("--old") + 1]) if "--old" in sys.argv else None
    libs = build(VARIANTS, "mla_attention.cu", "mrt_mla_decode")
    old_libs = (build(OLD_VARIANTS, "mla_attention.cu", "mrt_mla_decode", OLD_SIGNATURE,
                      csrc=old.resolve()) if old else {})
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for what, args in mla_rows(gen, dev):
        cells = []
        for name, lib in libs.items():
            cells.append(f"{name} {device_ms(lambda: new_launch(lib, *args)):.4f}")
        for name, lib in old_libs.items():
            cells.append(f"{name} {device_ms(lambda: old_launch(lib, *args)):.4f}")
        print(f"mla decode {what}: " + ", ".join(cells) + f" ms [{card}]", flush=True)
    timeline(card, gen, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
