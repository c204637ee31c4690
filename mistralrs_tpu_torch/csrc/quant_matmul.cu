// The wmma body of the dequant-matmul kernels, for Hopper (sm_90a).
//
// Replaces the TPU kernels of mistralrs_tpu/ops/quant_matmul.py:
//   _w8_matmul (:411) and _w8_matmul_l (:616) for more than 16 rows (the
//       W8 kernel's prefill body; at most 16 rows take the decode body of
//       csrc/w8_matmul.cu, as ops/quant_matmul.py::w8_plan chooses): one byte
//       per code, signed int8 without bias (Q8_0, Q6_K at group 16) or with
//       bias, or unsigned with bias.
//   _w8_matmul_g (:895): the grouped (MoE) form. Rows arrive sorted by
//       expert and padded so that each M-tile belongs to one expert; the
//       block reads that expert's id from tile_idx itself and offsets its
//       code, scale and bias pointers by the bank stride;
// and the TPU kernel of mistralrs_tpu/ops/moe_grouped.py:
//   _dense_matmul_g (:67; body _dense_g_kernel :32): the grouped form on a
//       bf16 bank [E, N, K] (a dense leaf of a quantized expert bank), the
//       third code format here, BF16.
// The GPU takes one layer's planes by pointer, so the stacked `_l` variants
// and the plain ones are one kernel here, and the grouped forms are the same
// body with a bank offset. The 4-bit packed codes (Q4_K) have their own
// kernel, csrc/w4_matmul.cu.
//
//   out[m, n] = sum_k x[m, k] * w[k, n],
//   w[k, n]   = bf16(scale[k / gs, n] * q[k, n] + bias[k / gs, n])
//   (BF16: w[k, n] = bank[e, n, k])
//
// The weight is dequantized exactly as the plain version does it (f32
// multiply, f32 add, round to bf16), so the two differ only in the order of
// the f32 sums. The "min" bias is folded into the dequantized tile, as the
// JAX package's XLA path does.
//
// What bounds it on the H100: for the grouped decode tiles the code bytes,
// 1 B per weight plus 4 or 8 B of scale and bias per group (BF16: 2 B per
// weight); at prefill (M >= 256) the bf16 tensor-core rate. Design: one
// block of 4 warps per 64 x 64 output tile walks K in steps of 128 rows.
// Each step stages the x tile [64 x 128] and the dequantized weight tile
// [128 x 64] in shared memory, so each code byte is read from device memory
// once per M-tile, and runs bf16 wmma 16x16x16 fragments with f32
// accumulators. The BF16 format stages the [64 x 128] K-contiguous weight
// tile as it is and reads it as a column-major B operand. There is no
// double-buffering, no split-K and no wgmma: the body is simple and right
// first; its times against the bound are in PERF.md (the W8 decode body of
// csrc/mm_decode.cuh is the redesign for one byte per code at <= 16 rows).
//
// Grouped form: at decode, 16 (token, choice) pairs spread over ~7 of 8
// experts, so each expert's group is padded to one M-tile: the kernel is
// templated on a 16-row tile (4 warps side by side over the 64 columns) for
// that case and keeps the 64-row tile for prefill. build_groups sizes the
// padded row count for the worst case; blocks whose M-tile lies at or past
// *n_used_tiles (the tiles of non-empty groups) write zeros and read no
// weights, so no expert's planes are streamed for an empty tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BN = 64;       // output columns per block
constexpr int BK = 64;       // half-step (rows of K)
constexpr int KS = 2 * BK;   // logical K rows per step
constexpr int THREADS = 128;
constexpr int XS_LD = KS + 8;  // padded row strides (bf16 elements)
constexpr int WS_LD = BN + 8;
constexpr int WT_LD = KS + 8;  // BF16: K-contiguous weight tile [BN x KS]
constexpr int CS_LD = BN + 4;  // f32
constexpr int MAX_LG = KS / 16;  // local groups per step at gs = 16

enum Fmt { U8 = 1, S8 = 2, BF16 = 3 };  // 0, the packed 4-bit format, is w4_matmul.cu's

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
  static constexpr int WS_BYTES = KS * WS_LD * 2;
  static constexpr int SB_BYTES = MAX_LG * BN * 4;
  static constexpr int MAIN_BYTES = XS_BYTES + WS_BYTES + 2 * SB_BYTES;
  static constexpr int CS_BYTES = BM * CS_LD * 4;
  static constexpr int SMEM_BYTES = MAIN_BYTES > CS_BYTES ? MAIN_BYTES : CS_BYTES;
  static_assert(BN * WT_LD * 2 <= WS_BYTES, "the BF16 weight tile must fit the W tile");
};

__device__ __forceinline__ float code_at(uint32_t word, int j, bool is_signed) {
  // byte j of a little-endian 32-bit word, unsigned or signed
  const uint32_t b = (word >> (8 * j)) & 0xFFu;
  return is_signed ? (float)(int8_t)b : (float)b;
}

// Dequantize 16 codes (one 16-byte chunk of a code row) into 16 bf16 values
// of weight-tile row `row`, columns [c, c+16).
template <bool HAS_BIAS>
__device__ __forceinline__ void deq16(const uint4& chunk, bool is_signed, const float* s_row,
                                      const float* b_row, int c, __nv_bfloat16* w_row) {
  const uint32_t words[4] = {chunk.x, chunk.y, chunk.z, chunk.w};
  __align__(16) __nv_bfloat16 vals[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float q = code_at(words[i >> 2], i & 3, is_signed);
    float w = __fmul_rn(q, s_row[c + i]);
    if (HAS_BIAS) w = __fadd_rn(w, b_row[c + i]);
    vals[i] = __float2bfloat16_rn(w);
  }
  uint4* dst = reinterpret_cast<uint4*>(w_row + c);
  const uint4* src = reinterpret_cast<const uint4*>(vals);
  dst[0] = src[0];
  dst[1] = src[1];
}

// Zero the block's output tile (an unused M-tile of a grouped call).
template <int BM>
__device__ __forceinline__ void zero_tile(void* out, int m0, int n0, int M, int N,
                                          int out_bf16) {
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int m = m0 + i / BN, n = n0 + i % BN;
    if (m < M && n < N) {
      if (out_bf16)
        reinterpret_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] = __float2bfloat16_rn(0.0f);
      else
        reinterpret_cast<float*>(out)[(size_t)m * N + n] = 0.0f;
    }
  }
}

// tile_idx == nullptr: one weight matrix. Otherwise a bank of experts:
// M-tile t multiplies expert tile_idx[t], whose planes start code_stride
// bytes and sb_stride floats after the previous expert's; tiles at or past
// *n_used write zeros. BF16: codes is the bf16 bank [E, N, K] (code_stride
// = N * K * 2 bytes), scale and bias are unused.
template <int FMT, bool HAS_BIAS, int BM>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    void* __restrict__ out, int M, int N, int K, int gs, int out_bf16,
                    const int* __restrict__ tile_idx, const int* __restrict__ n_used,
                    long long code_stride, long long sb_stride) {
  using T = Tiling<BM>;
  __shared__ __align__(128) unsigned char smem[T::SMEM_BYTES];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + T::XS_BYTES);
  float* ss = reinterpret_cast<float*>(smem + T::XS_BYTES + T::WS_BYTES);
  float* bs = ss + MAX_LG * BN;
  float* cs = reinterpret_cast<float*>(smem);  // epilogue staging (aliases)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  if (tile_idx != nullptr) {
    if ((int)blockIdx.y >= *n_used) {
      zero_tile<BM>(out, m0, n0, M, N, out_bf16);
      return;
    }
    const long long e = tile_idx[blockIdx.y];
    codes += e * code_stride;
    scale += e * sb_stride;
    if (HAS_BIAS) bias += e * sb_stride;
  }
  const int nsteps = K / KS;
  const int lg_per_half = FMT == BF16 ? 0 : BK / gs;
  const int n_lg = 2 * lg_per_half;
  const int wm = (warp / T::WARPS_N) * (T::FM * 16);
  const int wn = (warp % T::WARPS_N) * (T::FN * 16);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int s = 0; s < nsteps; ++s) {
    // K offset of each half of this step
    const int base0 = s * KS;
    const int base1 = s * KS + BK;

    // 1. scales (and biases) of the step's groups (none for BF16)
    for (int i = tid; i < n_lg * BN; i += THREADS) {
      const int lg = i / BN, c = i - lg * BN;
      const int half = lg / lg_per_half;
      const int g = (half ? base1 : base0) / gs + (lg - half * lg_per_half);
      const int n = n0 + c;
      ss[lg * BN + c] = n < N ? scale[(size_t)g * N + n] : 0.0f;
      if (HAS_BIAS) bs[lg * BN + c] = n < N ? bias[(size_t)g * N + n] : 0.0f;
    }
    // 2. x tile [BM x KS]: 16-byte chunks of 8 bf16
    for (int i = tid; i < BM * (KS / 8); i += THREADS) {
      const int r = i / (KS / 8), cc = (i - r * (KS / 8)) * 8;
      const int m = m0 + r;
      const int k = (cc < BK ? base0 + cc : base1 + (cc - BK));
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < M) v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
      *reinterpret_cast<uint4*>(xs + r * XS_LD + cc) = v;
    }
    __syncthreads();
    // 3. code tile → dequantized bf16 weight tile [KS x BN] (BF16: the bank's
    //    tile [BN x KS] as it is)
    if constexpr (FMT == BF16) {
      const auto* w = reinterpret_cast<const __nv_bfloat16*>(codes);
      for (int i = tid; i < BN * (KS / 8); i += THREADS) {
        const int r = i / (KS / 8), cc = (i - r * (KS / 8)) * 8;
        const int n = n0 + r;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (n < N) v = *reinterpret_cast<const uint4*>(w + (size_t)n * K + base0 + cc);
        *reinterpret_cast<uint4*>(ws + r * WT_LD + cc) = v;
      }
    } else {
      for (int i = tid; i < KS * (BN / 16); i += THREADS) {
        const int r = i / (BN / 16), c = (i - r * (BN / 16)) * 16;
        const int n = n0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (n < N) v = *reinterpret_cast<const uint4*>(codes + (size_t)(base0 + r) * N + n);
        const int lg = r / gs;
        deq16<HAS_BIAS>(v, FMT == S8, ss + lg * BN, bs + lg * BN, c, ws + r * WS_LD);
      }
    }
    __syncthreads();
    // 4. tensor-core products over the step
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[T::FM];
      using BLayout = std::conditional_t<FMT == BF16, wmma::col_major, wmma::row_major>;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b[T::FN];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm + i * 16) * XS_LD + kk, XS_LD);
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        if constexpr (FMT == BF16)
          wmma::load_matrix_sync(b[j], ws + (wn + j * 16) * WT_LD + kk, WT_LD);
        else
          wmma::load_matrix_sync(b[j], ws + kk * WS_LD + wn + j * 16, WS_LD);
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
    if (m < M && n < N) {
      const float v = cs[r * CS_LD + c];
      if (out_bf16)
        reinterpret_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] = __float2bfloat16_rn(v);
      else
        reinterpret_cast<float*>(out)[(size_t)m * N + n] = v;
    }
  }
}

struct Launch {
  const void* x;
  const void* codes;
  const void* scale;
  const void* bias;
  void* out;
  int M, N, K, gs, out_bf16;
  const int* tile_idx;
  const int* n_used;
  long long code_stride, sb_stride;
};

template <int FMT, int BM>
void launch_fmt(const Launch& a, cudaStream_t st) {
  dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  const auto* xp = static_cast<const __nv_bfloat16*>(a.x);
  const auto* cp = static_cast<const uint8_t*>(a.codes);
  const auto* sp = static_cast<const float*>(a.scale);
  const auto* bp = static_cast<const float*>(a.bias);
  if (FMT != BF16 && a.bias)
    quant_matmul_kernel<FMT, FMT != BF16, BM><<<grid, THREADS, 0, st>>>(
        xp, cp, sp, bp, a.out, a.M, a.N, a.K, a.gs, a.out_bf16, a.tile_idx, a.n_used,
        a.code_stride, a.sb_stride);
  else
    quant_matmul_kernel<FMT, false, BM><<<grid, THREADS, 0, st>>>(
        xp, cp, sp, bp, a.out, a.M, a.N, a.K, a.gs, a.out_bf16, a.tile_idx, a.n_used,
        a.code_stride, a.sb_stride);
}

template <int BM>
bool launch(const Launch& a, int fmt, cudaStream_t st) {
  if (fmt == U8)
    launch_fmt<U8, BM>(a, st);
  else if (fmt == S8)
    launch_fmt<S8, BM>(a, st);
  else if (fmt == BF16)
    launch_fmt<BF16, BM>(a, st);
  else
    return false;
  return true;
}

}  // namespace

// fmt: 1 = uint8 [K, N]; 2 = int8 [K, N]. bias may be NULL. Requires
// K % 128 == 0, N % 16 == 0, gs in {16, 32} (checked by the Python wrapper).
extern "C" int mrt_quant_matmul(const void* x, const void* codes, const void* scale,
                                const void* bias, void* out, int M, int N, int K, int gs,
                                int fmt, int out_bf16, void* stream) {
  const Launch a{x, codes, scale, bias, out, M, N, K, gs, out_bf16, nullptr, nullptr, 0, 0};
  if (fmt == BF16 || !launch<64>(a, fmt, static_cast<cudaStream_t>(stream)))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Grouped form over a bank of E experts: codes [E, K, N], scale and
// bias [E, K/gs, N] (fmt 3: codes is a bf16 bank [E, N, K], scale and bias
// NULL, gs unused); x [M, K] with M = (M / tm) row tiles, tile_idx [M / tm]
// int32 expert per tile, n_used one int32 on the device. tm in {16, 64}.
extern "C" int mrt_quant_matmul_grouped(const void* x, const void* codes, const void* scale,
                                        const void* bias, void* out, const void* tile_idx,
                                        const void* n_used, int M, int N, int K, int gs,
                                        int fmt, int out_bf16, int tm, long long code_stride,
                                        long long sb_stride, void* stream) {
  const Launch a{x, codes, scale, bias, out, M, N, K, gs, out_bf16,
                 static_cast<const int*>(tile_idx), static_cast<const int*>(n_used),
                 code_stride, sb_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok = tm == 16 ? launch<16>(a, fmt, st) : tm == 64 && launch<64>(a, fmt, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
