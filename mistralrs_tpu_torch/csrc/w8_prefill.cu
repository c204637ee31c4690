// W8 dequant-matmul for Hopper (sm_90a), prefill body: one byte per code,
// for more than 16 rows a tile (dense M > 16 in 64- or 128-row tiles, the
// grouped form's 64-row tiles). csrc/w8_matmul.cu holds the kernel's entry
// (mrt_w8_matmul, which checks the arguments and calls mrt_w8_prefill here)
// and says which TPU kernels it replaces; this body sits in its own source
// so that nvcc builds it beside the others.
//
//   out[m, n] = sum_k x[m, k] * w[k, n],
//   w[k, n]   = bf16(scale[k / gs, n] * q[k, n] + bias[k / gs, n])
//
// Bound: the bf16 tensor-core rate at large M; at Mixtral's shapes the
// dequantization and the L2 traffic of codes and x come close to it. So
// the weight is wgmma's A operand, dequantized straight into registers (the
// RS form: no B tile in shared memory, no proxy fence, no barrier between
// dequantization and product), and x the B operand:
// out^T [n, m] = W^T [n, k] x^T [k, m].
// - A block owns 256 output columns and BM = 64 or 128 rows (wgmma's N):
//   two consumer warpgroups of 128 columns each, two m64 A tiles per
//   warpgroup, and two producer warps. Row tiles vary fastest in the grid,
//   so the blocks that share a weight column tile run together.
// - The producers keep a ring of 5-8 stages (64 k rows each: x [BM x 64]
//   in the 128-byte swizzle, codes [64 x 256 B], the stage's 4, 2 or 1
//   scale and bias rows: groups of 16, of 32, or of 64 and more, a runtime
//   group size (GS = 0) whose row is k0 / gs, read past a bank's expert
//   offset as every group is) in flight with cp.async.cg,
//   each stage signalled by
//   cp.async.mbarrier.arrive on a "full" mbarrier; consumer warps free a
//   stage on an "empty" mbarrier once the wgmma that read it has retired.
// - A consumer warp reads its 16-column code chunks with ldmatrix.trans,
//   which gives each lane the bytes of its A fragment (lane (g, q): columns
//   2g, 2g+1 at k 2q, 2q+1, 2q+8, 2q+9), and turns each byte into the
//   weight exactly as the plain version does: one prmt puts the byte in the
//   mantissa of 2^23 (signed codes XORed with 0x80 first), one subtraction
//   gives the code exactly, then w = scale * q rounded to f32, + bias
//   rounded, and one rounding of the pair to bf16 (e4m3 bytes: the hardware
//   fp8 -> f16 conversion gives q exactly, then w = bf16(scale * q))
//   (tests/test_torch_w8_plan.py models it for all 256 byte values). The
//   fragments of k16 step j + 1 are made while the wgmmas of the steps
//   before run (register sets for 2 steps with 128-row tiles, 4 with 64-row
//   tiles, whose wgmmas are short; wgmma.wait_group keeps the rest queued).
// - A K split (dense only, when the tiles alone leave SMs idle) writes f32
//   partials to a workspace, and a second kernel sums them in split order,
//   so the result repeats bit for bit. (The decode body's scheme, the last
//   block of a tile summing every split, left the sum to one SM per tile:
//   with 64 KB partials that took longer than the products; PERF.md.)
// - Grouped, BM = 128: blockIdx.x is a 64-row tile; the first of each pair
//   of consecutive tiles of one expert takes both (its second one exits), so
//   each dequantized weight serves up to 128 rows.
//
// Needs K % 128 == 0 and N % 16 == 0 (checked by mrt_w8_matmul and the
// wrapper); columns past N and rows past M are zero-filled, never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mm_decode.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// PREFILL body
// ---------------------------------------------------------------------------

constexpr int P8_BN = 256;         // output columns per block
constexpr int P8_PRODUCERS = 64;   // two producer warps
constexpr int P8_STEP = 64;        // k rows per stage
constexpr int P8_SMEM = 232448;    // the most shared memory a block may have

// GS: the group size, or 0 for a runtime one of 64 or more
template <int BM, bool HB, int GS>
struct W8Prefill {
  static_assert(GS == 16 || GS == 32 || GS == 0, "groups of 16, 32, or a runtime gs >= 64");
  static constexpr int GROUPS = GS ? P8_STEP / GS : 1;    // scale rows per stage
  static constexpr int X = 0;                              // [BM][64 k = 128 B], SW128
  static constexpr int CODES = BM * 128;                   // [64 k][256 B], swizzled
  static constexpr int SCALE = CODES + P8_STEP * P8_BN;    // [GROUPS][256] f32
  static constexpr int BIAS = SCALE + GROUPS * P8_BN * 4;  // none without a bias plane
  static constexpr int STAGE = (BIAS + (HB ? GROUPS * P8_BN * 4 : 0) + 1023) / 1024 * 1024;
  static constexpr int FIT = (P8_SMEM - 2048) / (STAGE + 16);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int TOTAL = BARS + 2 * STAGES * 8 + 1024;  // + alignment slack
  static constexpr int THREADS = 256 + P8_PRODUCERS;
  // A-fragment register sets: k16 steps whose wgmma may still be in flight
  // while the next is made (64-row tiles: short wgmmas, so a deeper queue;
  // 128-row tiles: their accumulators leave registers for two)
  static constexpr int SETS = BM == 128 ? 2 : 4;
  static_assert(STAGES >= 4, "the ring needs at least 4 stages");
};

template <int BM>
__device__ __forceinline__ void wgmma_rs(float (&d)[BM / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (BM == 128)
    wgmma_rs_m64n128k16(d, a, db);
  else
    wgmma_rs_m64n64k16(d, a, db);
}

// The weight of byte `sel` of code word c, as the plain version computes it:
// the code exactly (the byte in the mantissa of 2^23 by one prmt, less 2^23,
// or less 2^23 + 128 for a signed code XORed with 0x80), scale * q rounded to
// f32, then + bias rounded.
template <int FMT, bool HB>
__device__ __forceinline__ float w8_weight(uint32_t c, uint32_t sel, float s, float b) {
  constexpr float MAGIC = FMT == S8 ? 8388736.0f : 8388608.0f;
  const float q = __fsub_rn(__uint_as_float(__byte_perm(c, 0x4B000000u, 0x7540u | sel)), MAGIC);
  const float w = __fmul_rn(s, q);
  return HB ? __fadd_rn(w, b) : w;
}

// The A fragment of a k16 step from the lane's code words (ldmatrix.trans:
// c0 holds code rows 2q, 2q+1 and c1 rows 2q+8, 2q+9, at columns 2g, 2g+1 in
// bytes 0, 2 and 1, 3): A rows g (column 2g) and g + 8 (column 2g + 1).
template <int FMT, bool HB>
__device__ __forceinline__ void w8_frag(uint32_t c0, uint32_t c1, float2 s, float2 b,
                                        uint32_t (&a)[4]) {
  if constexpr (FMT == E4M3) {  // the byte's exact value (hardware fp8 -> f16), then s * q
    const float4 p = e4m3x4(c0), r = e4m3x4(c1);
    a[0] = pack_bf16(__fmul_rn(s.x, p.x), __fmul_rn(s.x, p.z));
    a[1] = pack_bf16(__fmul_rn(s.y, p.y), __fmul_rn(s.y, p.w));
    a[2] = pack_bf16(__fmul_rn(s.x, r.x), __fmul_rn(s.x, r.z));
    a[3] = pack_bf16(__fmul_rn(s.y, r.y), __fmul_rn(s.y, r.w));
    return;
  }
  if (FMT == S8) {
    c0 ^= 0x80808080u;
    c1 ^= 0x80808080u;
  }
  a[0] = pack_bf16(w8_weight<FMT, HB>(c0, 0, s.x, b.x), w8_weight<FMT, HB>(c0, 2, s.x, b.x));
  a[1] = pack_bf16(w8_weight<FMT, HB>(c0, 1, s.y, b.y), w8_weight<FMT, HB>(c0, 3, s.y, b.y));
  a[2] = pack_bf16(w8_weight<FMT, HB>(c1, 0, s.x, b.x), w8_weight<FMT, HB>(c1, 2, s.x, b.x));
  a[3] = pack_bf16(w8_weight<FMT, HB>(c1, 1, s.y, b.y), w8_weight<FMT, HB>(c1, 3, s.y, b.y));
}

// tile_idx == nullptr: one matrix, blockIdx = (row tile, column tile, split).
// Otherwise blockIdx.x = a 64-row tile of a bank (one split).
template <int FMT, int BM, bool HB, int GS>
__global__ void __launch_bounds__(256 + P8_PRODUCERS, 1)
w8_prefill_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  void* __restrict__ out, int M, int N, int K, int out_bf16, int splits,
                  const int* __restrict__ tile_idx, const int* __restrict__ n_used,
                  long long code_stride, long long sb_stride, float* __restrict__ ws, int gs) {
  using L = W8Prefill<BM, HB, GS>;
  extern __shared__ uint8_t dsmem[];
  const uint32_t raw = smem_u32(dsmem);
  uint8_t* smem = dsmem + ((1024 - (raw & 1023)) & 1023);
  const uint32_t smem_a = smem_u32(smem);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * P8_BN;
  int m0, rows, split = 0;  // the block's first row, its real rows, its K split
  if (tile_idx != nullptr) {
    const int t = blockIdx.x, used = *n_used;
    m0 = 64 * t;
    if (t >= used) {
      zero_tile(out, m0, 64, n0, P8_BN, N, out_bf16);
      return;
    }
    const int e = tile_idx[t];
    rows = 64;
    if (BM == 128) {  // the first tile of each pair of one expert's tiles leads
      int first = t;
      while (first > 0 && tile_idx[first - 1] == e) --first;
      if ((t - first) & 1) return;
      if (t + 1 < used && tile_idx[t + 1] == e) rows = 128;
    }
    codes += (long long)e * code_stride;
    scale += (long long)e * sb_stride;
    if (HB) bias += (long long)e * sb_stride;
  } else {
    m0 = blockIdx.x * BM;
    rows = M - m0 < BM ? M - m0 : BM;
    split = blockIdx.z;
  }
  const int nsteps = K / P8_STEP;
  const int s_begin = (int)((long long)split * nsteps / splits);
  const int n = (int)((long long)(split + 1) * nsteps / splits) - s_begin;
  const uint32_t full = smem_a + L::BARS, empty = full + 8 * L::STAGES;
  if (tid == 0) {
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(full + 8 * i, P8_PRODUCERS);  // one cp.async arrival per producer thread
      mbar_init(empty + 8 * i, 8);            // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // producer warps
    const int p = tid - 256;
    for (int i = 0; i < n; ++i) {
      const int slot = i % L::STAGES;
      mbar_wait(empty + 8 * slot, ((i / L::STAGES) & 1) ^ 1);
      const uint32_t st = smem_a + slot * L::STAGE;
      const int k0 = (s_begin + i) * P8_STEP;
      // each thread's share of a stage has a fixed count, so the loops
      // unroll with no loop control. x: the block's rows (zero past its real
      // rows), chunk c of row r at c ^ (r % 8) (the 128-byte swizzle wgmma
      // reads)
#pragma unroll
      for (int jj = 0; jj < BM * 8 / P8_PRODUCERS; ++jj) {
        const int j = p + jj * P8_PRODUCERS, r = j >> 3, c = j & 7;
        const bool ok = r < rows;
        cp_async16(st + L::X + r * 128 + ((c ^ (r & 7)) << 4),
                   x + (ok ? (size_t)(m0 + r) * K + k0 + c * 8 : 0), ok);
      }
      // codes: 64 rows x 16 chunks of 16 columns, chunk c of row r at
      // c ^ (r % 8), so the 8 rows one ldmatrix reads hit 8 bank groups
#pragma unroll
      for (int jj = 0; jj < P8_STEP * 16 / P8_PRODUCERS; ++jj) {
        const int j = p + jj * P8_PRODUCERS, r = j >> 4, c = j & 15;
        const int col = n0 + 16 * c;
        const bool ok = col < N;
        cp_async16(st + L::CODES + r * P8_BN + ((c ^ (r & 7)) << 4),
                   codes + (ok ? (size_t)(k0 + r) * N + col : 0), ok);
      }
      // scale and bias: GROUPS rows x 64 chunks of 4 columns
      const int g0 = GS ? k0 / GS : (int)((unsigned)k0 / (unsigned)gs);
#pragma unroll
      for (int jj = 0; jj < L::GROUPS * 64 / P8_PRODUCERS; ++jj) {
        const int j = p + jj * P8_PRODUCERS, g = j >> 6, c = j & 63;
        const int col = n0 + 4 * c;
        const bool ok = col < N;
        const size_t at = ok ? (size_t)(g0 + g) * N + col : 0;
        cp_async16(st + L::SCALE + (g * P8_BN + 4 * c) * 4, scale + at, ok);
        if (HB) cp_async16(st + L::BIAS + (g * P8_BN + 4 * c) * 4, bias + at, ok);
      }
      cp_async_mbar_arrive(full + 8 * slot);
    }
    cp_async_wait<0>();
    return;
  }

  // consumer warpgroups: warp w of warpgroup wg multiplies A tiles t = 0, 1,
  // the block's 16-column code chunks 8 wg + 4 t + w
  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  float acc[2][BM / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[t][i] = 0.0f;
  uint32_t a[L::SETS][2][4];  // [register set: k16 step % SETS][A tile][fragment]

  for (int i = 0; i < n; ++i) {
    const int slot = i % L::STAGES;
    mbar_wait(full + 8 * slot, (i / L::STAGES) & 1);
    fence_proxy_async();  // the cp.async writes, before wgmma reads x
    const uint32_t st = smem_a + slot * L::STAGE;
    const float* ss = reinterpret_cast<const float*>(smem + slot * L::STAGE + L::SCALE);
    const float* bs = reinterpret_cast<const float*>(smem + slot * L::STAGE + L::BIAS);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // code rows 32 h .. 32 h + 31: two k16 steps
      uint32_t cw[2][2][2];        // [A tile][k16 step of the half][rows 0-7 | 8-15]
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const unsigned r = 32 * h + lane, ci = 8 * wg + 4 * t + w;
        ldsm_x4_trans(st + L::CODES + r * P8_BN + ((ci ^ (r & 7)) << 4), cw[t][0][0],
                      cw[t][0][1], cw[t][1][0], cw[t][1][1]);
      }
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int kk = 2 * h + kh, grp = GS ? kk * 16 / GS : 0;
        uint32_t(&cur)[2][4] = a[kk % L::SETS];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int col = 16 * (8 * wg + 4 * t + w) + 2 * g;
          const float2 s2 = *reinterpret_cast<const float2*>(ss + grp * P8_BN + col);
          float2 b2 = make_float2(0.0f, 0.0f);
          if (HB) b2 = *reinterpret_cast<const float2*>(bs + grp * P8_BN + col);
          w8_frag<FMT, HB>(cw[t][kh][0], cw[t][kh][1], s2, b2, cur[t]);
        }
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wgmma_fence();
        const uint64_t db = sw128_desc(st + L::X + kk * 32, 16, 1024);
        wgmma_rs<BM>(acc[0], cur[0], db);
        wgmma_rs<BM>(acc[1], cur[1], db);
        wgmma_commit();
        // the group SETS - 1 steps back has retired: its set is free; from
        // kk = SETS - 2 on, that includes the previous stage's last group
        wgmma_wait<L::SETS - 1>();
        fence_regs(a[(kk + 1) % L::SETS][0]);
        fence_regs(a[(kk + 1) % L::SETS][1]);
        if (kk == L::SETS - 2 && i > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % L::STAGES));
        }
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // lane (g, q) holds, for A tile t, columns na, na + 1 (A rows g, g + 8) at
  // rows 8 j + 2 q + hh: acc[t][4 j + hh] (column na), acc[t][4 j + 2 + hh]
  // (column na + 1); a K split writes its f32 partial instead
  float* part = ws + (size_t)split * M * N;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int na = n0 + 16 * (8 * wg + 4 * t + w) + 2 * g;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 8 * j + 2 * q + hh;
        if (m < rows && na < N) {
          const size_t idx = (size_t)(m0 + m) * N + na;
          if (splits == 1)
            store_pair(out, idx, acc[t][4 * j + hh], acc[t][4 * j + 2 + hh], out_bf16);
          else
            *reinterpret_cast<float2*>(part + idx) =
                make_float2(acc[t][4 * j + hh], acc[t][4 * j + 2 + hh]);
        }
      }
  }
}

// The K splits' sum: out = the f32 partials [splits, M, N] summed in split
// order (so the result repeats bit for bit), 4 outputs a thread over the
// whole card: the sum is bound by the partials' L2 traffic, not by one SM's
// share of it.
__global__ void __launch_bounds__(256)
w8_split_sum_kernel(const float* __restrict__ ws, void* __restrict__ out, int M, int N,
                    int splits, int out_bf16) {
  const size_t total = (size_t)M * N;
  const size_t i = ((size_t)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= total) return;
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int sp = 0; sp < splits; ++sp) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(ws + sp * total + i));
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  if (out_bf16)
    *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(out) + i) =
        make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
  else
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + i) = sum;
}

// Launch the prefill body (and the sum of its K splits); returns the error
// of the shared-memory opt-in, if any. The launches' own errors are the
// caller's cudaGetLastError().
template <int FMT, int BM, bool HB, int GS>
cudaError_t launch_prefill(const DecodeArgs& a, cudaStream_t st) {
  using L = W8Prefill<BM, HB, GS>;
  auto kernel = w8_prefill_kernel<FMT, BM, HB, GS>;
  static cudaError_t opt_in =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::TOTAL);
  if (opt_in != cudaSuccess) return opt_in;
  const bool grouped = a.tile_idx != nullptr;
  const dim3 grid(grouped ? a.M / 64 : (a.M + BM - 1) / BM, (a.N + P8_BN - 1) / P8_BN,
                  grouped ? 1 : a.splits);
  kernel<<<grid, L::THREADS, L::TOTAL, st>>>(a.x, a.codes, a.scale, a.bias, a.out, a.M, a.N, a.K,
                                             a.out_bf16, a.splits, a.tile_idx, a.n_used,
                                             a.code_stride, a.sb_stride, a.ws, a.gs);
  if (a.splits > 1) {
    const size_t quads = (size_t)a.M * a.N / 4;
    w8_split_sum_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(a.ws, a.out, a.M, a.N,
                                                                         a.splits, a.out_bf16);
  }
  return cudaSuccess;
}

template <int FMT, bool HB, int GS>
cudaError_t launch_tile(const DecodeArgs& a, int tile, cudaStream_t st) {
  if (tile == 64) return launch_prefill<FMT, 64, HB, GS>(a, st);
  if (tile == 128) return launch_prefill<FMT, 128, HB, GS>(a, st);
  return cudaErrorInvalidValue;
}

template <bool HB>
cudaError_t launch(const DecodeArgs& a, int fmt, int gs, int tile, cudaStream_t st) {
  if (fmt == U8 && gs == 32) return launch_tile<U8, HB, 32>(a, tile, st);
  if (fmt == U8 && gs == 16) return launch_tile<U8, HB, 16>(a, tile, st);
  if (fmt == S8 && gs == 32) return launch_tile<S8, HB, 32>(a, tile, st);
  if (fmt == S8 && gs == 16) return launch_tile<S8, HB, 16>(a, tile, st);
  if (fmt == U8 && gs % 64 == 0) return launch_tile<U8, HB, 0>(a, tile, st);
  if (fmt == S8 && gs % 64 == 0) return launch_tile<S8, HB, 0>(a, tile, st);
  if constexpr (!HB) {
    if (fmt == E4M3 && gs % 64 == 0) return launch_tile<E4M3, false, 0>(a, tile, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The prefill body of mrt_w8_matmul (csrc/w8_matmul.cu), which has checked
// the arguments: tile 64 or 128 rows, 256 columns per block, a workspace f32
// [splits, M, N] when splits > 1 (counters unused); returns the launches'
// CUDA error.
extern "C" int mrt_w8_prefill(const void* x, const void* codes, const void* scale,
                              const void* bias, void* out, const void* tile_idx,
                              const void* n_used, int M, int N, int K, int gs, int fmt,
                              int out_bf16, int tile, int splits, long long code_stride,
                              long long sb_stride, void* workspace, void* counters,
                              void* stream) {
  const DecodeArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
                     static_cast<const float*>(scale), static_cast<const float*>(bias), out, M, N,
                     K, out_bf16, splits, static_cast<const int*>(tile_idx),
                     static_cast<const int*>(n_used), code_stride, sb_stride,
                     static_cast<float*>(workspace), static_cast<int*>(counters), gs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bias ? launch<true>(a, fmt, gs, tile, st)
                             : launch<false>(a, fmt, gs, tile, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
