// W8 dequant-matmul for Hopper (sm_90a): one byte per code.
//
// Replaces the TPU kernels of mistralrs_tpu/ops/quant_matmul.py:
//   _w8_matmul (:411) and _w8_matmul_l (:616), body _w8_kernel (:202), and
//   _w8_matmul_g (:895), the grouped (MoE) form: signed int8 codes without
//   bias (Q8_0 at group 32, Q6_K at group 16), unsigned codes with bias, and
//   signed codes with bias (the widened form). Its e4m3 form (fmt 3, one
//   matrix, no bias) computes mistralrs_tpu/quant/fp8.py's fp8_matmul
//   (:84-95, XLA in the JAX package): FP8 weights with blockwise or
//   per-tensor scales as a group-bk or group-K scale plane.
//
//   out[m, n] = sum_k x[m, k] * (scale[k / gs, n] * q[k, n] + bias[k / gs, n])
//
// Codes are [K, N] (a bank: [E, K, N]), scale and bias planes f32 [K/gs, N]
// (gs 16, 32, 64, or any multiple of 128 that divides K: GPTQ's group 128,
// and per-column scales, gs = K; for one matrix and a bank alike); bias may
// be absent.
// The grouped form multiplies row tile t by expert tile_idx[t] of a bank
// (planes code_stride bytes and sb_stride floats apart); tiles at or past
// *n_used write zeros and read no weights.
//
// Two bodies, chosen by the wrapper's w8_plan (ops/quant_matmul.py):
//
// DECODE (a row tile of at most 16 rows: dense M <= 16, grouped tm = 16).
//   The body of csrc/mm_decode.cuh in its U8 and S8 formats, which it shares
//   with the W4 kernel: blocks of 128 columns (or 64 where 128 cannot give
//   >= 2 blocks per SM), K split for one matrix, a 4-stage cp.async ring,
//   mma.sync with the weight as the 16-row operand, each byte split into two
//   nibbles that are exact bf16 values, scale and bias applied to f32 group
//   sums of x. Bound: the code bytes (1 B per weight plus 4 or 8 B of scale
//   and bias per group).
//
// PREFILL (more rows: dense M > 16 in 64- or 128-row tiles, grouped tm = 64).
//   The body of csrc/w8_prefill.cu (its own source, so that nvcc builds it
//   beside this one): wgmma with the weight as the A operand, dequantized
//   into registers exactly as the plain version does it, x as the B operand;
//   blocks of 256 columns and 64 or 128 rows, K split for one matrix where
//   the tiles alone leave SMs idle, a bank's tiles taken in pairs of one
//   expert. That file says how it is built.
//
// Both bodies need K % 128 == 0 and N % 16 == 0 (checked by the wrapper and
// here); columns past N and rows past M are zero-filled, never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mm_decode.cuh"

namespace {

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// decode body: tile 8 or 16 rows, blocks of 128 (8 warps: each code row a
// block reads is one 128-byte line) or 64 columns (4 warps), as the
// wrapper's plan chooses
template <int FMT, bool HB, int GS>
cudaError_t launch_body(const DecodeArgs& a, int tile, int columns, cudaStream_t st) {
  if (tile == 8 && columns == 128) return launch_decode<FMT, 1, HB, GS, 8>(a, st);
  if (tile == 8 && columns == 64) return launch_decode<FMT, 1, HB, GS, 4>(a, st);
  if (tile == 16 && columns == 128) return launch_decode<FMT, 2, HB, GS, 8>(a, st);
  if (tile == 16 && columns == 64) return launch_decode<FMT, 2, HB, GS, 4>(a, st);
  return cudaErrorInvalidValue;
}

// groups of 16, 32 and 64 are template constants; a multiple of 128 is the
// runtime-group form (GS = 0), one plane row a step
template <bool HB>
cudaError_t launch(const DecodeArgs& a, int fmt, int gs, int tile, int columns,
                   cudaStream_t st) {
  if (fmt == U8 && gs == 32) return launch_body<U8, HB, 32>(a, tile, columns, st);
  if (fmt == U8 && gs == 16) return launch_body<U8, HB, 16>(a, tile, columns, st);
  if (fmt == U8 && gs == 64) return launch_body<U8, HB, 64>(a, tile, columns, st);
  if (fmt == U8 && gs % 128 == 0) return launch_body<U8, HB, 0>(a, tile, columns, st);
  if (fmt == S8 && gs == 32) return launch_body<S8, HB, 32>(a, tile, columns, st);
  if (fmt == S8 && gs == 16) return launch_body<S8, HB, 16>(a, tile, columns, st);
  if (fmt == S8 && gs == 64) return launch_body<S8, HB, 64>(a, tile, columns, st);
  if (fmt == S8 && gs % 128 == 0) return launch_body<S8, HB, 0>(a, tile, columns, st);
  if constexpr (!HB) {
    if (fmt == E4M3 && gs == 64) return launch_body<E4M3, false, 64>(a, tile, columns, st);
    if (fmt == E4M3 && gs % 128 == 0) return launch_body<E4M3, false, 0>(a, tile, columns, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// the prefill body (csrc/w8_prefill.cu)
extern "C" int mrt_w8_prefill(const void* x, const void* codes, const void* scale,
                              const void* bias, void* out, const void* tile_idx,
                              const void* n_used, int M, int N, int K, int gs, int fmt,
                              int out_bf16, int tile, int splits, long long code_stride,
                              long long sb_stride, void* workspace, void* counters,
                              void* stream);

// W8 matmul: x [M, K] bf16, codes [(E,) K, N] (fmt 1: uint8, 2: int8, 3:
// e4m3 of one matrix without bias), scale and bias [(E,) K/gs, N] f32 (bias
// may be NULL), out [M, N] (bf16 or f32); gs 16, 32, 64 or a multiple of 128
// dividing K (e4m3: 64 or a multiple of 128).
// body 0 (decode): tile 8 or 16 rows, `columns` 64 or 128 per block; dense:
//   M <= tile, grid.y = splits of K's K/128 steps, workspace f32 [splits, M,
//   N] and counters int32 [ceil(N / columns)] (all zero, left zero) when
//   splits > 1; grouped: tile 16, one split.
// body 1 (prefill): tile 64 or 128 rows, `columns` 256; dense: splits of
//   K's K/64 steps, workspace f32 [splits, M, N] when splits > 1 (counters
//   unused); grouped: 64-row tiles (tile 128: pairs of one expert's tiles
//   per block), one split.
// Grouped when tile_idx is given: M / 16 (decode) or M / 64 (prefill) row
// tiles, tile_idx int32 experts, n_used one int32 on the device.
extern "C" int mrt_w8_matmul(const void* x, const void* codes, const void* scale,
                             const void* bias, void* out, const void* tile_idx,
                             const void* n_used, int M, int N, int K, int gs, int fmt,
                             int out_bf16, int body, int tile, int splits, int columns,
                             long long code_stride, long long sb_stride, void* workspace,
                             void* counters, void* stream) {
  const bool grouped = tile_idx != nullptr;
  const int steps = body == 0 ? K / 128 : K / 64;
  const bool ok = K > 0 && K % 128 == 0 && N > 0 && N % 16 == 0 && M > 0 && splits >= 1 &&
                  splits <= steps &&
                  (gs == 16 || gs == 32 || gs == 64 || (gs > 0 && gs % 128 == 0 && K % gs == 0)) &&
                  (grouped ? (n_used != nullptr && splits == 1 &&
                              (body == 0 ? tile == 16 && M % 16 == 0 : M % 64 == 0))
                           : (body == 1 || M <= tile)) &&
                  (body == 0 || (body == 1 && columns == 256 && (tile == 64 || tile == 128))) &&
                  (splits == 1 || (workspace != nullptr && (body == 1 || counters != nullptr))) &&
                  (fmt != E4M3 || (bias == nullptr && !grouped && gs % 64 == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  if (body == 1)
    return mrt_w8_prefill(x, codes, scale, bias, out, tile_idx, n_used, M, N, K, gs, fmt,
                          out_bf16, tile, splits, code_stride, sb_stride, workspace, counters,
                          stream);
  const DecodeArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
                     static_cast<const float*>(scale), static_cast<const float*>(bias), out, M, N,
                     K, out_bf16, splits, static_cast<const int*>(tile_idx),
                     static_cast<const int*>(n_used), code_stride, sb_stride,
                     static_cast<float*>(workspace), static_cast<int*>(counters), gs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bias ? launch<true>(a, fmt, gs, tile, columns, st)
                             : launch<false>(a, fmt, gs, tile, columns, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
