// The dense grouped kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel of mistralrs_tpu/ops/moe_grouped.py:
//   _dense_matmul_g (:67; body _dense_g_kernel :32): the grouped (MoE) form
//   on a bf16 bank [E, N, K] (a dense leaf of an expert bank). Rows arrive
//   sorted by expert and padded so that each row tile belongs to one expert;
//   a block reads that expert's id from tile_idx and offsets its weight
//   pointer by the bank stride. Tiles at or past *n_used (the tiles of
//   non-empty groups, a device scalar) write zeros and read no weights.
//
//   out[m, n] = sum_k x[m, k] * bank[tile_idx[m / tm], n, k]
//
// The bank is K-contiguous, so a weight tile [columns x k] is already the
// K-major operand the tensor cores read. Two bodies, chosen by the row
// tile (ops/moe_grouped.py: dense_grouped_plan):
//
// DECODE (16-row tiles). Bound: the weight bytes (2 B per weight), so the
// design keeps loads in flight on every SM, as the quantized kernels'
// decode body (csrc/mm_decode.cuh) does, in a body of its own: that one is
// built around [K, N] code planes with scale and bias groups, this one reads
// [N, K] bf16 rows.
//   - Blocks of 4 warps own 64 output columns and walk all of K; a step is
//     64 k, so each weight row a block reads is one 128-byte line. (Blocks
//     of 128 columns and K split across blocks were never faster on the
//     DeepSeek-V2-Lite and Mixtral-8x7B banks: PERF.md.)
//   - A ring of 4 stages (the weight tile and the tile's 16 x rows) filled
//     by 16-byte cp.async.cg copies: three steps are in flight while one is
//     multiplied.
//   - mma.sync m16n8k16 with the weight tile as the 16-row A operand
//     (ldmatrix, no transpose: A row i is column 2i, row i + 8 column 2i + 1,
//     so a lane holds two neighbouring columns) and the tile's 16 rows of x
//     as two 8-column B operands: out^T = W x^T, no padded rows.
//
// PREFILL (64-row tiles). Bound: the weight bytes at these routings (each
// expert's weight read once for up to 128 rows), the bf16 tensor-core rate
// above. wgmma in its SS form: the weight tile as the A operand and x as B,
// both K-major in the 128-byte swizzle (out^T = W x^T), f32 accumulators.
//   - A block owns 256 columns: two consumer warpgroups of 128 columns
//     each (two m64 A tiles), and a producer warpgroup that keeps a ring of
//     4 stages (64 k: the weight tile [256 x 64], x [rows x 64]) in flight
//     with cp.async.cg, each stage signalled by cp.async.mbarrier.arrive on
//     a "full" mbarrier; consumer warps free a stage on an "empty" mbarrier
//     once the wgmma that read it has retired. The loads bound the body
//     (PERF.md): four producer warps, one on each of the SM's sub-partitions,
//     stream up to 1.25x faster than two.
//   - The first of each pair of consecutive 64-row tiles of one expert
//     takes both (its second exits), so each weight tile serves up to 128
//     rows (wgmma N = 128; N = 64 for a tile without a partner). Row tiles
//     vary fastest in the grid, so blocks that share a weight tile run
//     together and find it in L2.
//   - The output tile is staged in the drained ring and stored in 16-byte
//     rows.
//
// Needs K % 64 == 0 and N % 16 == 0 (the wrapper checks K % 128); columns
// past N are zero-filled, never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"
#include "wgmma.cuh"

namespace {

constexpr int DG_STEP = 64;  // k per stage: 128 bytes of a weight row

__device__ inline void zero_rows(__nv_bfloat16* out, int m0, int rows, int n0, int cols, int N,
                                 int nthreads) {
  for (int i = threadIdx.x; i < rows * cols; i += nthreads) {
    const int m = m0 + i / cols, n = n0 + i % cols;
    if (n < N) out[(size_t)m * N + n] = __float2bfloat16_rn(0.0f);
  }
}

// ---------------------------------------------------------------------------
// DECODE body: 16-row tiles, mma.sync
// ---------------------------------------------------------------------------

constexpr int DD_STAGES = 4;
constexpr int DD_BN = 64;  // output columns per block
constexpr int DD_THREADS = 128;
// the weight tile [DD_BN rows][128 B]: chunk c of row r at c ^ ((r / 2) % 8),
// so the 8 even (or odd) rows one ldmatrix reads hit 8 bank groups
constexpr int DD_W = 0;
constexpr int DD_X = DD_BN * 128;  // x [16 rows][128 B]: chunk c of row r at c ^ (r % 8)
constexpr int DD_STAGE = DD_X + 16 * 128;
constexpr int DD_TOTAL = DD_STAGES * DD_STAGE;  // 40 KB
static_assert(DD_BN * 8 % DD_THREADS == 0, "whole weight rows per pass");

// grid (column blocks, row tiles)
__global__ void __launch_bounds__(DD_THREADS)
dense_g_decode_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ out, int N, int K,
                      const int* __restrict__ tile_idx, const int* __restrict__ n_used,
                      long long bank_stride) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * DD_BN, t = blockIdx.y, m0 = 16 * t;
  if (t >= *n_used) {
    zero_rows(out, m0, 16, n0, DD_BN, N, DD_THREADS);
    return;
  }
  w += tile_idx[t] * bank_stride;
  const int n = K / DG_STEP;
  const uint32_t sa = smem_u32(smem);

  // each thread's share of a stage has a fixed count, so the loops unroll
  // with no loop control
  auto load = [&](int slot, int step) {
    const uint32_t st = sa + slot * DD_STAGE;
    const int k0 = step * DG_STEP;
#pragma unroll
    for (int j = 0; j < DD_BN * 8 / DD_THREADS; ++j) {
      const unsigned i = tid + j * DD_THREADS, r = i >> 3, c = i & 7;
      const int col = n0 + (int)r;
      const bool ok = col < N;
      cp_async16(st + DD_W + r * 128 + ((c ^ ((r >> 1) & 7)) << 4),
                 w + (ok ? (size_t)col * K + k0 + c * 8 : 0), ok);
    }
    for (int i = tid; i < 16 * 8; i += DD_THREADS) {
      const unsigned r = i >> 3, c = i & 7;
      cp_async16(st + DD_X + r * 128 + ((c ^ (r & 7)) << 4), x + (size_t)(m0 + r) * K + k0 + c * 8,
                 true);
    }
  };

  float acc[2][4];  // [x rows 0-7 | 8-15][fragment]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.0f;
  // the lane's ldmatrix rows: A row (lane % 8) of matrix (lane / 8) is
  // weight row 16 warp + 2 (lane % 8) + (lane / 8) % 2 at chunk 2 kc + lane / 16;
  // x row (lane % 8) + 8 (lane / 16) at chunk 2 kc + (lane / 8) % 2
  const unsigned wr = 16 * warp + 2 * (lane & 7) + ((lane >> 3) & 1), wc = lane >> 4;
  const unsigned xr = (lane & 7) + ((lane >> 4) << 3), xc = (lane >> 3) & 1;
  auto compute = [&](int slot) {
    const uint32_t st = sa + slot * DD_STAGE;
#pragma unroll
    for (int kc = 0; kc < DG_STEP / 16; ++kc) {
      uint32_t a0, a1, a2, a3, b0, b1, b2, b3;
      ldsm_x4(st + DD_W + wr * 128 + (((2 * kc + wc) ^ ((wr >> 1) & 7)) << 4), a0, a1, a2, a3);
      ldsm_x4(st + DD_X + xr * 128 + (((2 * kc + xc) ^ (xr & 7)) << 4), b0, b1, b2, b3);
      mma_bf16(acc[0], a0, a1, a2, a3, b0, b1);
      mma_bf16(acc[1], a0, a1, a2, a3, b2, b3);
    }
  };

#pragma unroll
  for (int i = 0; i < DD_STAGES - 1; ++i) {
    if (i < n) load(i, i);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    cp_async_wait<DD_STAGES - 2>();
    __syncthreads();
    const int j = it + DD_STAGES - 1;
    if (j < n) load(j % DD_STAGES, j);
    cp_async_commit();
    compute(it % DD_STAGES);
  }
  cp_async_wait<0>();

  // lane (g, q) holds columns na, na + 1 at x rows 8 mt + 2q + j:
  // acc[mt][j] and acc[mt][2 + j]
  const int g = lane >> 2, q = lane & 3;
  const int na = n0 + 16 * warp + 2 * g;
  if (na >= N) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<uint32_t*>(out + (size_t)(m0 + 8 * mt + 2 * q + j) * N + na) =
          pack_bf16(acc[mt][j], acc[mt][2 + j]);
}

// ---------------------------------------------------------------------------
// PREFILL body: 64-row tiles (in pairs of one expert), wgmma SS
// ---------------------------------------------------------------------------

constexpr int DP_BN = 256;          // output columns per block
constexpr int DP_T = DP_BN / 128;   // m64 A tiles per consumer warpgroup
constexpr int DP_PRODUCERS = 128;   // a producer warpgroup
constexpr int DP_STAGES = 4;
constexpr int DP_W = 0;                        // [DP_BN columns][64 k = 128 B], SW128
constexpr int DP_X = DP_BN * 128;              // [128 rows][128 B], SW128
constexpr int DP_STAGE = DP_X + 128 * 128;     // 48 KB
constexpr int DP_BARS = DP_STAGES * DP_STAGE;  // 192 KB
constexpr int DP_TOTAL = DP_BARS + 2 * DP_STAGES * 8 + 1024;  // + alignment slack
constexpr int DP_PITCH = DP_BN * 2 + 16;       // bytes per staged output row
constexpr int DP_THREADS = 256 + DP_PRODUCERS;
static_assert(128 * DP_PITCH <= DP_BARS, "the output tile must fit the drained ring");

template <int R>
__device__ __forceinline__ void wgmma_kk(float (&d)[R / 2], uint64_t da, uint64_t db) {
  if constexpr (R == 128)
    wgmma_m64n128k16<0>(d, da, db);
  else
    wgmma_m64n64k16<0>(d, da, db);
}

// The consumer warpgroups' walk over K for R rows (wgmma N) and the
// epilogue: warp w of warpgroup wg multiplies A tiles t = 0, 1, the block's
// columns 128 wg + 64 t .. + 63, and stages its results in the drained ring.
template <int R>
__device__ __forceinline__ void dense_prefill_consume(uint8_t* smem, uint32_t smem_a, int nsteps,
                                                      uint32_t full, uint32_t empty) {
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  float acc[DP_T][R / 2];
#pragma unroll
  for (int t = 0; t < DP_T; ++t)
#pragma unroll
    for (int i = 0; i < R / 2; ++i) acc[t][i] = 0.0f;
  for (int i = 0; i < nsteps; ++i) {
    const int slot = i % DP_STAGES;
    mbar_wait(full + 8 * slot, (i / DP_STAGES) & 1);
    fence_proxy_async();  // the cp.async writes, before wgmma reads them
    const uint32_t st = smem_a + slot * DP_STAGE;
#pragma unroll
    for (int t = 0; t < DP_T; ++t) fence_regs(acc[t]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DG_STEP / 16; ++kk) {
      const uint64_t db = sw128_desc(st + DP_X + kk * 32, 16, 1024);
#pragma unroll
      for (int t = 0; t < DP_T; ++t)
        wgmma_kk<R>(acc[t],
                    sw128_desc(st + DP_W + (DP_BN / 2 * wg + 64 * t) * 128 + kk * 32, 16, 1024),
                    db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's group has retired: free its slot
#pragma unroll
    for (int t = 0; t < DP_T; ++t) fence_regs(acc[t]);
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % DP_STAGES));
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < DP_T; ++t) fence_regs(acc[t]);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // every consumer is done with the ring
  // lane (g, q) holds, for A tile t, columns c and c + 8 (A rows g, g + 8) at
  // rows 8 j + 2q + hh: acc[t][4 j + hh] and acc[t][4 j + 2 + hh]
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < DP_T; ++t) {
    const int c = DP_BN / 2 * wg + 64 * t + 16 * w + g;
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        __nv_bfloat16* row = reinterpret_cast<__nv_bfloat16*>(smem + (8 * j + 2 * q + hh) * DP_PITCH);
        row[c] = __float2bfloat16_rn(acc[t][4 * j + hh]);
        row[c + 8] = __float2bfloat16_rn(acc[t][4 * j + 2 + hh]);
      }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// grid (64-row tiles, column blocks)
__global__ void __launch_bounds__(DP_THREADS, 1)
dense_g_prefill_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ out, int N, int K,
                       const int* __restrict__ tile_idx, const int* __restrict__ n_used,
                       long long bank_stride) {
  extern __shared__ uint8_t dsmem[];
  const uint32_t raw = smem_u32(dsmem);
  uint8_t* smem = dsmem + ((1024 - (raw & 1023)) & 1023);
  const uint32_t smem_a = smem_u32(smem);
  const int tid = threadIdx.x;
  const int t = blockIdx.x, n0 = blockIdx.y * DP_BN, m0 = 64 * t, used = *n_used;
  if (t >= used) {
    zero_rows(out, m0, 64, n0, DP_BN, N, DP_THREADS);
    return;
  }
  // the first tile of each pair of one expert's tiles leads
  const int e = tile_idx[t];
  int first = t;
  while (first > 0 && tile_idx[first - 1] == e) --first;
  if ((t - first) & 1) return;
  const int rows = t + 1 < used && tile_idx[t + 1] == e ? 128 : 64;
  w += e * bank_stride;
  const int nsteps = K / DG_STEP;
  const uint32_t full = smem_a + DP_BARS, empty = full + 8 * DP_STAGES;
  if (tid == 0) {
    for (int i = 0; i < DP_STAGES; ++i) {
      mbar_init(full + 8 * i, DP_PRODUCERS);  // one cp.async arrival per producer thread
      mbar_init(empty + 8 * i, 8);            // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // the producer warpgroup: chunk c of row r at c ^ (r % 8) (the 128-byte
    // swizzle wgmma reads), weight rows past N zero-filled
    const int p = tid - 256;
    for (int i = 0; i < nsteps; ++i) {
      const int slot = i % DP_STAGES;
      mbar_wait(empty + 8 * slot, ((i / DP_STAGES) & 1) ^ 1);
      const uint32_t st = smem_a + slot * DP_STAGE;
      const int k0 = i * DG_STEP;
#pragma unroll
      for (int jj = 0; jj < DP_BN * 8 / DP_PRODUCERS; ++jj) {
        const int j = p + jj * DP_PRODUCERS, r = j >> 3, c = j & 7;
        const bool ok = n0 + r < N;
        cp_async16(st + DP_W + r * 128 + ((c ^ (r & 7)) << 4),
                   w + (ok ? (size_t)(n0 + r) * K + k0 + c * 8 : 0), ok);
      }
      for (int j = p; j < rows * 8; j += DP_PRODUCERS) {
        const int r = j >> 3, c = j & 7;
        cp_async16(st + DP_X + r * 128 + ((c ^ (r & 7)) << 4),
                   x + (size_t)(m0 + r) * K + k0 + c * 8, true);
      }
      cp_async_mbar_arrive(full + 8 * slot);
    }
    cp_async_wait<0>();
    return;
  }
  if (rows == 128)
    dense_prefill_consume<128>(smem, smem_a, nsteps, full, empty);
  else
    dense_prefill_consume<64>(smem, smem_a, nsteps, full, empty);
  // the staged [rows x 256] tile, 16 bytes a thread
  constexpr int CHUNKS = DP_BN * 2 / 16;
  for (int i = tid; i < rows * CHUNKS; i += 256) {
    const int r = i / CHUNKS, c = i % CHUNKS, col = n0 + 8 * c;
    if (col < N)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + col) =
          *reinterpret_cast<const uint4*>(smem + r * DP_PITCH + 16 * c);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  __nv_bfloat16* out;
  int M, N, K;
  const int* tile_idx;
  const int* n_used;
  long long bank_stride;
};

cudaError_t launch_decode(const Args& a, cudaStream_t st) {
  const dim3 grid((a.N + DD_BN - 1) / DD_BN, a.M / 16);
  dense_g_decode_kernel<<<grid, DD_THREADS, DD_TOTAL, st>>>(a.x, a.w, a.out, a.N, a.K, a.tile_idx,
                                                            a.n_used, a.bank_stride);
  return cudaSuccess;
}

cudaError_t launch_prefill(const Args& a, cudaStream_t st) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      dense_g_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DP_TOTAL);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid(a.M / 64, (a.N + DP_BN - 1) / DP_BN);
  dense_g_prefill_kernel<<<grid, DP_THREADS, DP_TOTAL, st>>>(a.x, a.w, a.out, a.N, a.K,
                                                             a.tile_idx, a.n_used, a.bank_stride);
  return cudaSuccess;
}

}  // namespace

// Dense grouped matmul over a bf16 bank w [E, N, K] (bank_stride = N * K
// values): x [M, K] bf16 in M / tm row tiles, tile_idx [M / tm] int32 expert
// per tile, n_used one int32 on the device; out [M, N] bf16. tm 16 runs the
// decode body, tm 64 the prefill body. K % 64 == 0, N % 16 == 0.
extern "C" int mrt_dense_matmul_grouped(const void* x, const void* w, void* out,
                                        const void* tile_idx, const void* n_used, int M, int N,
                                        int K, int tm, long long bank_stride, void* stream) {
  const bool ok = K > 0 && K % DG_STEP == 0 && N > 0 && N % 16 == 0 && M > 0 &&
                  (tm == 16 || tm == 64) && M % tm == 0 && n_used != nullptr &&
                  tile_idx != nullptr;
  if (!ok) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
               static_cast<__nv_bfloat16*>(out), M, N, K, static_cast<const int*>(tile_idx),
               static_cast<const int*>(n_used), bank_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = tm == 64 ? launch_prefill(a, st) : launch_decode(a, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
