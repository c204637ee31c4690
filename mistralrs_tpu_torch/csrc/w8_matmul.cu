// W8 dequant-matmul for Hopper (sm_90a), decode body: one byte per code.
//
// Replaces, for a row tile of at most 16 rows (dense M <= 16), the TPU
// kernels of mistralrs_tpu/ops/quant_matmul.py:
//   _w8_matmul (:411) and _w8_matmul_l (:616), body _w8_kernel (:202):
//   signed int8 codes without bias (Q8_0 at group 32, Q6_K at group 16),
//   unsigned codes with bias, and signed codes with bias (the widened form).
//
//   out[m, n] = sum_k x[m, k] * (scale[k / gs, n] * q[k, n] + bias[k / gs, n])
//
// The body is csrc/mm_decode.cuh's, shared with the W4 kernel, in its U8
// and S8 formats, with blocks of 128 columns (or W4's 64 where 128 cannot
// give >= 2 blocks per SM): split K (>= 2 blocks per SM), a 4-stage
// cp.async ring of 128-row steps, mma.sync with the weight as the 16-row operand, each byte
// split into two nibbles that are exact bf16 values, and scale and bias
// applied to f32 group sums of x. Bound: the code bytes (1 B per weight
// plus 4 or 8 B of scale and bias per group). Larger row counts (M > 16)
// take the wmma body of csrc/quant_matmul.cu, a choice of the wrapper's
// plan (ops/quant_matmul.py::w8_plan).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mm_decode.cuh"

namespace {

template <int FMT, int MT, bool HB, int NW>
cudaError_t launch_gs(const DecodeArgs& a, int gs, cudaStream_t st) {
  if (gs == 32) return launch_decode<FMT, MT, HB, 32, NW>(a, st);
  if (gs == 16) return launch_decode<FMT, MT, HB, 16, NW>(a, st);
  return cudaErrorInvalidValue;
}

// blocks of 8 warps (128 columns: each code row a block reads is one
// 128-byte line) or 4 warps (64 columns), as the wrapper's plan chooses
template <int FMT, int MT, bool HB>
cudaError_t launch_cols(const DecodeArgs& a, int columns, int gs, cudaStream_t st) {
  if (columns == 128) return launch_gs<FMT, MT, HB, 8>(a, gs, st);
  if (columns == 64) return launch_gs<FMT, MT, HB, 4>(a, gs, st);
  return cudaErrorInvalidValue;
}

template <int FMT, bool HB>
cudaError_t launch_tile(const DecodeArgs& a, int tile, int columns, int gs, cudaStream_t st) {
  if (tile == 8) return launch_cols<FMT, 1, HB>(a, columns, gs, st);
  if (tile == 16) return launch_cols<FMT, 2, HB>(a, columns, gs, st);
  return cudaErrorInvalidValue;
}

template <bool HB>
cudaError_t launch_fmt(const DecodeArgs& a, int fmt, int tile, int columns, int gs,
                       cudaStream_t st) {
  if (fmt == U8) return launch_tile<U8, HB>(a, tile, columns, gs, st);
  if (fmt == S8) return launch_tile<S8, HB>(a, tile, columns, gs, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// W8 matmul, decode body: x [M, K] bf16, codes [K, N] (fmt 1: uint8, 2:
// int8), scale and bias [K/gs, N] f32 (bias may be NULL), out [M, N] (bf16
// or f32); gs 16 or 32; tile 8 or 16 rows with M <= tile; blocks of
// `columns` (64 or 128) output columns; grid.y = splits of K's K/128 steps,
// with workspace f32 [splits, M, N] and counters int32 [ceil(N / columns)]
// (all zero, left zero) when splits > 1.
extern "C" int mrt_w8_matmul(const void* x, const void* codes, const void* scale,
                             const void* bias, void* out, int M, int N, int K, int gs, int fmt,
                             int out_bf16, int tile, int splits, int columns, void* workspace,
                             void* counters, void* stream) {
  const bool ok = K > 0 && K % 128 == 0 && N > 0 && N % 16 == 0 && M > 0 && M <= tile &&
                  splits >= 1 && splits <= K / 128 &&
                  (splits == 1 || (workspace != nullptr && counters != nullptr));
  if (!ok) return (int)cudaErrorInvalidValue;
  const DecodeArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
                     static_cast<const float*>(scale), static_cast<const float*>(bias), out, M, N,
                     K, out_bf16, splits, nullptr, nullptr, 0, 0,
                     static_cast<float*>(workspace), static_cast<int*>(counters)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bias ? launch_fmt<true>(a, fmt, tile, columns, gs, st)
                             : launch_fmt<false>(a, fmt, tile, columns, gs, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
