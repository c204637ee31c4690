// The wmma body of the dense grouped kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel of mistralrs_tpu/ops/moe_grouped.py:
//   _dense_matmul_g (:67; body _dense_g_kernel :32): the grouped (MoE) form
//   on a bf16 bank [E, N, K] (a dense leaf of an expert bank). Rows arrive
//   sorted by expert and padded so that each M-tile belongs to one expert;
//   the block reads that expert's id from tile_idx itself and offsets its
//   weight pointer by the bank stride.
//
//   out[m, n] = sum_k x[m, k] * bank[tile_idx[m / tm], n, k]
//
// What bounds it on the H100: for the decode tiles the weight bytes (2 B per
// weight); at prefill (M >= 256) the bf16 tensor-core rate. Design: one block
// of 4 warps per 64 x 64 output tile walks K in steps of 128. Each step
// stages the x tile [64 x 128] and the bank's K-contiguous weight tile
// [64 x 128] in shared memory, so each weight is read from device memory once
// per M-tile, and runs bf16 wmma 16x16x16 fragments (the weight tile read as a
// column-major B operand) with f32 accumulators. There is no
// double-buffering, no split-K and no wgmma: the body is simple and right
// first; its times against the bound are in PERF.md.
//
// At decode, 16 (token, choice) pairs spread over ~7 of 8 experts, so each
// expert's group is padded to one M-tile: the kernel is templated on a
// 16-row tile (4 warps side by side over the 64 columns) for that case and
// keeps the 64-row tile for prefill. build_groups sizes the padded row count
// for the worst case; blocks whose M-tile lies at or past *n_used_tiles (the
// tiles of non-empty groups) write zeros and read no weights, so no expert's
// weights are streamed for an empty tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BN = 64;       // output columns per block
constexpr int KS = 128;      // K per step
constexpr int THREADS = 128;
constexpr int XS_LD = KS + 8;  // padded row strides (bf16 elements)
constexpr int WT_LD = KS + 8;  // the K-contiguous weight tile [BN x KS]
constexpr int CS_LD = BN + 4;  // f32
// Shared memory a 16-row block holds beyond its tiles (4 KB). The footprint
// sets how many blocks an SM holds and what is left for L1: without these
// bytes the decode rows moved by up to 20 % either way (PERF.md), so
// they stay until the dense grouped kernel is retuned as a whole.
constexpr int KEPT_BYTES_16 = 2 * 8 * BN * 4;

// Shared-memory layout and warp tiling for an M-tile of BM rows (64 or 16).
// 64: 2 x 2 warps, each 32 x 32 (2 x 2 fragments); 16: 1 x 4 warps, each
// 16 x 16 (one fragment).
template <int BM>
struct Tiling {
  static constexpr int WARPS_N = BM >= 32 ? 2 : 4;
  static constexpr int WARPS_M = 4 / WARPS_N;
  static constexpr int FM = BM / (16 * WARPS_M);
  static constexpr int FN = BN / (16 * WARPS_N);
  static constexpr int XS_BYTES = BM * XS_LD * 2;
  static constexpr int WT_BYTES = KS * (BN + 8) * 2;  // holds the [BN x KS] tile
  static constexpr int MAIN_BYTES = XS_BYTES + WT_BYTES + (BM == 16 ? KEPT_BYTES_16 : 0);
  static constexpr int CS_BYTES = BM * CS_LD * 4;
  static constexpr int SMEM_BYTES = MAIN_BYTES > CS_BYTES ? MAIN_BYTES : CS_BYTES;
  static_assert(BN * WT_LD * 2 <= WT_BYTES, "the weight tile must fit");
};

// M-tile t multiplies expert tile_idx[t], whose weights start bank_stride
// bf16 values after the previous expert's; tiles at or past *n_used write
// zeros.
template <int BM>
__global__ void __launch_bounds__(THREADS)
dense_grouped_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ out, int M, int N, int K,
                     const int* __restrict__ tile_idx, const int* __restrict__ n_used,
                     long long bank_stride) {
  using T = Tiling<BM>;
  __shared__ __align__(128) unsigned char smem[T::SMEM_BYTES];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem + T::XS_BYTES);
  float* cs = reinterpret_cast<float*>(smem);  // epilogue staging (aliases)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  if ((int)blockIdx.y >= *n_used) {
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int m = m0 + i / BN, n = n0 + i % BN;
      if (m < M && n < N) out[(size_t)m * N + n] = __float2bfloat16_rn(0.0f);
    }
    return;
  }
  w += tile_idx[blockIdx.y] * bank_stride;
  const int nsteps = K / KS;
  const int wm = (warp / T::WARPS_N) * (T::FM * 16);
  const int wn = (warp % T::WARPS_N) * (T::FN * 16);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int s = 0; s < nsteps; ++s) {
    const int base = s * KS;
    // x tile [BM x KS]: 16-byte chunks of 8 bf16
    for (int i = tid; i < BM * (KS / 8); i += THREADS) {
      const int r = i / (KS / 8), cc = (i - r * (KS / 8)) * 8;
      const int m = m0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < M) v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + base + cc);
      *reinterpret_cast<uint4*>(xs + r * XS_LD + cc) = v;
    }
    __syncthreads();
    // the bank's weight tile [BN x KS] as it is
    for (int i = tid; i < BN * (KS / 8); i += THREADS) {
      const int r = i / (KS / 8), cc = (i - r * (KS / 8)) * 8;
      const int n = n0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n < N) v = *reinterpret_cast<const uint4*>(w + (size_t)n * K + base + cc);
      *reinterpret_cast<uint4*>(wt + r * WT_LD + cc) = v;
    }
    __syncthreads();
    // tensor-core products over the step
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[T::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[T::FN];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm + i * 16) * XS_LD + kk, XS_LD);
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        wmma::load_matrix_sync(b[j], wt + (wn + j * 16) * WT_LD + kk, WT_LD);
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  // epilogue: fragments → shared staging → masked, coalesced stores
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
      wmma::store_matrix_sync(cs + (wm + i * 16) * CS_LD + wn + j * 16, acc[i][j], CS_LD,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i - r * BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) out[(size_t)m * N + n] = __float2bfloat16_rn(cs[r * CS_LD + c]);
  }
}

template <int BM>
void launch(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* out, int M, int N,
            int K, const int* tile_idx, const int* n_used, long long bank_stride,
            cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dense_grouped_kernel<BM><<<grid, THREADS, 0, st>>>(x, w, out, M, N, K, tile_idx, n_used,
                                                     bank_stride);
}

}  // namespace

// Dense grouped matmul over a bf16 bank w [E, N, K] (bank_stride = N * K
// values): x [M, K] bf16 with M / tm row tiles, tile_idx [M / tm] int32
// expert per tile, n_used one int32 on the device; out [M, N] bf16. tm in
// {16, 64}; K % 128 == 0, N % 16 == 0 (checked by the Python wrapper).
extern "C" int mrt_dense_matmul_grouped(const void* x, const void* w, void* out,
                                        const void* tile_idx, const void* n_used, int M, int N,
                                        int K, int tm, long long bank_stride, void* stream) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const auto* ti = static_cast<const int*>(tile_idx);
  const auto* nu = static_cast<const int*>(n_used);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tm == 16)
    launch<16>(xp, wp, op, M, N, K, ti, nu, bank_stride, st);
  else if (tm == 64)
    launch<64>(xp, wp, op, M, N, K, ti, nu, bank_stride, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
