// The decode body of the dequant-matmul kernels, for Hopper (sm_90a),
// shared by the W4 kernel (csrc/w4_matmul.cu: split-half packed 4-bit
// codes) and the W8 kernel (csrc/w8_matmul.cu: one byte per code).
//
//   out[m, n] = sum_k x[m, k] * (scale[k / gs, n] * q[k, n] + bias[k / gs, n])
//
// for a row tile of at most 16 rows (dense M <= 16; the grouped forms'
// 16-row tiles, W4 and W8 alike). Bound: the weight bytes (W4 0.75 B per weight, W8 1.125 to
// 1.5 B: the code plus 4 or 8 B of scale and bias per group), so the design
// keeps loads in flight on every SM. A step is 128 logical rows of K.
//   - Blocks of NW warps own 16 NW output columns (W4: 4 warps, 64 columns;
//     W8: 8 warps and 128 columns, so each code row a block reads is one
//     128-byte line, which streams faster than 64-byte halves, or 4 warps
//     where that leaves the card short of blocks); the wrapper's plan
//     (ops/quant_matmul.py: w4_plan, w8_plan, decode_splits) splits K so that
//     the grid has >= 2 blocks per SM. Each split writes f32 partials to a workspace; the last
//     block of a column tile to arrive (an int counter per tile, reset by
//     that block) sums the splits in split order, so the result does not
//     depend on which block came last: no float atomics.
//   - A ring of 4 stages (codes, scale and bias, x rows) filled by 16-byte
//     cp.async.cg copies: three steps are in flight while one is multiplied
//     (W4 29-42 KB per block, W8 45-116 KB; dynamic shared memory).
//   - Only the real rows of x are staged. The MMA is mma.sync m16n8k16 with
//     the weight as the 16-row A operand and x as the 8-row B operand
//     ("swap A/B": out^T = W^T x^T), so N fills the MMA's M side and the
//     <= 8 (or <= 16, two B tiles) rows of x its N side: no padded rows.
//     ldmatrix.trans turns a [16 code rows x 16 byte columns] tile into A
//     fragments: lane (g, q) gets bytes (row 2q, col 2g), (2q, 2g+1),
//     (2q+1, 2g), (2q+1, 2g+1), so bytes 0 and 2 are A row g (output column
//     2g) at k = 2q, 2q+1 and bytes 1 and 3 A row g + 8 (column 2g + 1): rows
//     of A are output columns in the order 0, 2, 4, .., 1, 3, 5, ..
//   - Dequantization leaves the inner loop, as the TPU kernel's f32dot_bias
//     branch does: codes become exact bf16 values OFF + u by mask-and-or
//     (below), the tensor cores sum x * (OFF + u) per group in f32, and a
//     second MMA against ones gives the group sums of x. Per group,
//     acc += scale * sum(x (OFF + u)) + (bias - OFF' scale) * sum(x) in f32.
//     The weight is never rounded to bf16, so the result is closer to the
//     exact product than the plain version (which rounds w to bf16); the
//     two agree within 1e-2 of the largest |out| (tests, chip_smoke.py).
//
// Codes by format:
//   PACKED4: [K/2, N] uint8; byte row r holds k = r in its low nibble and
//     k = K/2 + r in its high nibble, so a step is 64 byte rows covering x's
//     columns [64 s, 64 s + 64) and [K/2 + 64 s, ...). One mask-and-or makes
//     two nibbles the bf16 pair (128 + q0, 128 + q1); OFF = OFF' = 128.
//   U8 / S8: [K, N] one byte per weight; a step is 128 rows. A byte u does
//     not fit a bf16 mantissa after an offset (128 + u >= 256 has ulp 2), so
//     it is split: the low nibble as bf16 128 + lo (or with 0x4300) and the
//     high nibble as bf16 2048 + 16 hi (or with 0x4500: exponent 2^11, ulp
//     16), both exact, both multiplied into one accumulator:
//     sum x (128 + lo) + sum x (2048 + 16 hi) = sum x (2176 + u). Signed
//     codes -128..127 become u = q + 128 by XOR 0x80, so OFF' = 2176 (U8) or
//     2304 (S8). tests/test_torch_w8_plan.py holds the conversion exact for
//     all 256 byte values.
//   E4M3: [K, N] one fp8 e4m3 byte per weight (FP8 checkpoints: JAX
//     quant/fp8.py's fp8_matmul), no bias plane. The bytes do not fit the
//     mask-and-or trick (their exponent field varies), so the hardware
//     conversion cvt.rn.f16x2.e4m3x2 turns each pair into exact halves, the
//     halves become f32 and then bf16 pairs (every e4m3 value, subnormals
//     included, is exact in bf16): one MMA per chunk gives sum x * w per group,
//     and acc += scale * that sum (no ones MMA: no bias, no offset).
//     tests/test_torch_w8_plan.py holds the conversion exact for all 256 byte
//     values.
// Scale and bias planes are f32 [K/gs, N]; bias may be absent. Group sizes:
// PACKED4 16 (Q2_K's 2-bit codes: each half's 64 rows span 4 groups, so a
// step reads 8 plane rows), 32, 64 or 128 (those over 32 dividing K/2:
// GPTQ, AWQ);
// U8/S8 16, 32, 64, or any multiple of 128 that divides K (GPTQ's 128, and
// per-column scales: gs = K); E4M3 64 or a multiple of 128 dividing K (a
// 128 x 128 block scale is a group-128 plane, a per-tensor one gs = K). A group smaller than a step's span (PACKED4:
// each half's 64 rows; U8/S8: 128 rows) is a template constant (GS) and a
// step reads span / GS rows of the planes; a group of a span or more is a
// runtime value (GS = 0) and a step reads the one row its span lies in,
// k0 / gs: by linearity a group's sum is the sum of its steps' parts, so a
// group that spans several steps, or that a K split cuts, needs nothing
// more. The grouped form (every format) multiplies row tile t by
// expert tile_idx[t] of a bank (planes code_stride bytes and sb_stride
// floats apart), one split a tile; tiles at or past *n_used write zeros and
// read no weights.
// Requires K % 128 == 0 and N % 16 == 0; columns past N and rows past M are
// zero-filled, never read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

// Internal linkage: each source that includes this gets its own copies (the
// kernels are compiled per source, with no device link).
namespace {

// the nibbles at bits 0-3 and 16-19 of v as the bf16 pair (128 + q0, 128 + q1)
__device__ __forceinline__ uint32_t nib_pair(uint32_t v) {
  return (v & 0x000F000Fu) | 0x43004300u;
}
// the same nibbles as the bf16 pair (2048 + 16 q0, 2048 + 16 q1)
__device__ __forceinline__ uint32_t nib_pair_x16(uint32_t v) {
  return (v & 0x000F000Fu) | 0x45004500u;
}

// the four e4m3 bytes of c (byte 0 in .x) as exact f32 values, through the
// hardware fp8 -> f16 pair conversion
__device__ __forceinline__ float4 e4m3x4(uint32_t c) {
  const __half2 lo(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(c & 0xFFFFu), __NV_E4M3));
  const __half2 hi(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(c >> 16), __NV_E4M3));
  const float2 a = __half22float2(lo), b = __half22float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store_pair(void* out, size_t idx, float a, float b, int out_bf16) {
  if (out_bf16)
    *reinterpret_cast<uint32_t*>(reinterpret_cast<__nv_bfloat16*>(out) + idx) = pack_bf16(a, b);
  else
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + idx) = make_float2(a, b);
}

// Zero rows [m0, m0 + rows) x columns [n0, n0 + cols) of out (an unused
// tile of a grouped call).
__device__ inline void zero_tile(void* out, int m0, int rows, int n0, int cols, int N,
                                 int out_bf16) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int m = m0 + i / cols, n = n0 + i % cols;
    if (n < N) {
      if (out_bf16)
        reinterpret_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] = __float2bfloat16_rn(0.0f);
      else
        reinterpret_cast<float*>(out)[(size_t)m * N + n] = 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// the decode body
// ---------------------------------------------------------------------------

enum CodeFmt { PACKED4 = 0, U8 = 1, S8 = 2, E4M3 = 3 };  // the wrappers' format numbers

constexpr int D_STAGES = 4;
constexpr int D_XLD = 272;  // bytes per staged x row: 128 bf16 of the step, 16 pad
constexpr uint32_t BF16_ONES = 0x3F803F80u;

// The block's shape and shared-memory stage: MT row tiles of 8 rows, GS the
// group size (0: a runtime group of a span or more), HB a bias plane, NW
// warps of 16 output columns each.
template <int FMT, int MT, bool HB, int GS, int NW>
struct Decode {
  static constexpr int BN = 16 * NW;                      // output columns per block
  static constexpr int THREADS = 32 * NW;
  static constexpr int CHUNKS = BN / 16;                  // 16-byte chunks per code row
  static constexpr int ROWS = FMT == PACKED4 ? 64 : 128;  // code rows per step
  // logical K a step reads contiguously (PACKED4: each half), the K of a
  // group within it, and the groups a span holds
  static constexpr int SPAN = FMT == PACKED4 ? 64 : 128;
  static constexpr int G = GS ? GS : SPAN;
  static constexpr int GPS = SPAN / G;
  static constexpr int GROUPS = (FMT == PACKED4 ? 2 : 1) * GPS;  // plane rows per step
  static constexpr int CODES = 0;                         // [ROWS][BN B], swizzled
  // [GROUPS][BN] f32; PACKED4's low half's groups, then the high half's
  static constexpr int SCALE = ROWS * BN;
  static constexpr int BIAS = SCALE + GROUPS * BN * 4;  // none without a bias plane
  static constexpr int X = BIAS + (HB ? GROUPS * BN * 4 : 0);  // [8 MT rows][D_XLD B]
  static constexpr int STAGE = X + 8 * MT * D_XLD;
  static constexpr int TOTAL = D_STAGES * STAGE;
  static_assert(FMT == PACKED4 ? (GS == 16 || GS == 32 || GS == 0)
                                : (GS == 16 || GS == 32 || GS == 64 || GS == 0),
                "PACKED4: groups of 16 or 32 or a runtime 64 or 128; U8/S8: 16, 32, 64 or "
                "a runtime multiple of 128");
  static_assert(FMT != E4M3 || (!HB && (GS == 64 || GS == 0)),
                "E4M3: no bias plane, groups of 64 or a runtime multiple of 128");
  static_assert(NW == 4 || NW == 8, "code rows of 64 or 128 bytes");
  // chunk c of code row r sits at c ^ swz(r): the 8 rows one ldmatrix reads
  // at one logical chunk land in 8 different 16-byte bank groups
  // (unsigned shifts and masks: the body is bound by instruction issue, and
  // signed division by powers of two costs extra instructions)
  __device__ static __forceinline__ unsigned swz(unsigned r) {
    return (r >> (BN == 64 ? 1 : 0)) & (CHUNKS - 1);
  }
};

// tile_idx == nullptr: one matrix, M <= 8 MT rows, blockIdx.y = the split.
// Otherwise blockIdx.y = a 16-row tile of a bank (MT = 2, one split).
template <int FMT, int MT, bool HAS_BIAS, int GS, int NW>
__global__ void __launch_bounds__(32 * NW)
mm_decode_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 void* __restrict__ out, int M, int N, int K, int out_bf16, int splits,
                 const int* __restrict__ tile_idx, const int* __restrict__ n_used,
                 long long code_stride, long long sb_stride, float* __restrict__ ws,
                 int* __restrict__ counters, int gs) {
  using L = Decode<FMT, MT, HAS_BIAS, GS, NW>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * L::BN;
  int m0 = 0, rows = M, split = 0;
  if (tile_idx != nullptr) {
    m0 = blockIdx.y * 16;
    rows = 16;
    if ((int)blockIdx.y >= *n_used) {
      zero_tile(out, m0, 16, n0, L::BN, N, out_bf16);
      return;
    }
    const long long e = tile_idx[blockIdx.y];
    codes += e * code_stride;
    scale += e * sb_stride;
    if (HAS_BIAS) bias += e * sb_stride;
  } else {
    split = blockIdx.y;
  }
  const int kh = K / 2;
  // the group size (unsigned: the body is bound by instruction issue) and,
  // for PACKED4, the first group of the high half
  const unsigned gsz = GS ? GS : (unsigned)gs;
  const int gh = (int)((unsigned)kh / gsz);
  const int nsteps = K / 128;
  const int s_begin = (int)((long long)split * nsteps / splits);
  const int n = (int)((long long)(split + 1) * nsteps / splits) - s_begin;

  // rows of x past the tile's real rows stay zero in every stage
  for (int i = tid; i < D_STAGES * (8 * MT - rows) * (D_XLD / 16); i += L::THREADS) {
    const int per = (8 * MT - rows) * (D_XLD / 16);
    const int slot = i / per, rem = i % per;
    const int r = rows + rem / (D_XLD / 16), c = rem % (D_XLD / 16);
    *reinterpret_cast<uint4*>(smem + slot * L::STAGE + L::X + r * D_XLD + c * 16) =
        make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const uint32_t smem_a = smem_u32(smem);
  // each thread's share of a stage's copies has a fixed count, so the loops
  // below unroll with no loop control (the body is bound by instruction issue)
  constexpr int SB = L::GROUPS * (L::BN / 4);        // 16-byte chunks per plane
  constexpr int SB_ALL = (HAS_BIAS ? 2 : 1) * SB;    // of the scale and bias
  static_assert(L::ROWS * L::CHUNKS % L::THREADS == 0, "whole code rows per pass");
  // GS = 0: a group spans gsteps steps; the plane row of the next step to
  // load is kept as (row, steps into it), as steps are loaded in order (no
  // division a step: the body is bound by instruction issue)
  const unsigned gsteps = GS ? 1u : gsz / L::SPAN;
  unsigned next_row = GS ? 0u : (unsigned)s_begin / gsteps;
  unsigned next_rem = GS ? 0u : (unsigned)s_begin % gsteps;
  auto load = [&](int slot, int step) {
    const uint32_t st = smem_a + slot * L::STAGE;
    // codes: ROWS rows x CHUNKS chunks of 16 columns, swizzled
#pragma unroll
    for (int j = 0; j < L::ROWS * L::CHUNKS / L::THREADS; ++j) {
      const unsigned i = threadIdx.x + j * L::THREADS;
      const unsigned r = i / L::CHUNKS, c = i % L::CHUNKS;
      const int col = n0 + 16 * (int)c;
      const bool ok = col < N;
      cp_async16(st + L::CODES + r * L::BN + ((c ^ L::swz(r)) << 4),
                 codes + (ok ? (size_t)(step * L::ROWS + (int)r) * N + col : 0), ok);
    }
    // scale and bias of the step's groups, BN / 4 chunks of 4 columns each
#pragma unroll
    for (int j = 0; j < (SB_ALL + L::THREADS - 1) / L::THREADS; ++j) {
      const unsigned i = threadIdx.x + j * L::THREADS;
      if (SB_ALL % L::THREADS != 0 && i >= SB_ALL) break;
      const unsigned which = i / SB, g = i % SB / (L::BN / 4), c = i % (L::BN / 4);
      // the first plane row of the step's span (of each half for PACKED4)
      const int g0 = GS ? step * L::GPS : (int)next_row;
      int grow;
      if constexpr (FMT == PACKED4)
        grow = g < L::GPS ? g0 + (int)g : gh + g0 + ((int)g - L::GPS);
      else
        grow = g0 + (int)g;
      const int col = n0 + 4 * (int)c;
      const bool ok = col < N;
      const float* plane = which ? bias : scale;
      cp_async16(st + (which ? L::BIAS : L::SCALE) + (g * L::BN + c * 4) * 4,
                 plane + (ok ? (size_t)grow * N + col : 0), ok);
    }
    if (!GS && ++next_rem == gsteps) {
      next_rem = 0;
      ++next_row;
    }
    // x: the tile's real rows, 128 values each (PACKED4: 64 lo and 64 hi)
    for (int i = tid; i < rows * 16; i += L::THREADS) {
      const int r = i >> 4, h = (i >> 3) & 1, c = i & 7;
      const int k = FMT == PACKED4 ? h * kh + step * 64 + c * 8 : step * 128 + h * 64 + c * 8;
      cp_async16(st + L::X + r * D_XLD + h * 128 + c * 16, x + (size_t)(m0 + r) * K + k, true);
    }
  };

  const int g = lane >> 2;
  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j] = 0.0f;

  // x fragments: lane's matrix (rows 8 mt.., k 8 kk..) for ldmatrix
  const int xq = (lane >> 3) & (MT == 2 ? 3 : 1);
  const int xrow_off = L::X + (8 * (xq >> 1) + (lane & 7)) * D_XLD + (xq & 1) * 16;
  auto x_frag = [&](uint32_t xa, uint32_t (&b)[2][2]) {
    if (MT == 2)
      ldsm_x4(xa, b[0][0], b[0][1], b[1][0], b[1][1]);
    else
      ldsm_x2(xa, b[0][0], b[0][1]);
  };
  // acc += s * tq + (bias - off * s) * t1 for the warp's columns of group gidx
  auto apply = [&](const float* ss, const float* bs, int gidx, float off, float (&tq)[MT][4],
                   float (&t1)[MT][4]) {
    const float2 s2 = *reinterpret_cast<const float2*>(ss + gidx * L::BN + 16 * warp + 2 * g);
    float2 b2 = make_float2(0.0f, 0.0f);
    if (HAS_BIAS) b2 = *reinterpret_cast<const float2*>(bs + gidx * L::BN + 16 * warp + 2 * g);
    const float ca = fmaf(-off, s2.x, b2.x), cb = fmaf(-off, s2.y, b2.y);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[mt][0] = fmaf(s2.x, tq[mt][0], fmaf(ca, t1[mt][0], acc[mt][0]));
      acc[mt][1] = fmaf(s2.x, tq[mt][1], fmaf(ca, t1[mt][1], acc[mt][1]));
      acc[mt][2] = fmaf(s2.y, tq[mt][2], fmaf(cb, t1[mt][2], acc[mt][2]));
      acc[mt][3] = fmaf(s2.y, tq[mt][3], fmaf(cb, t1[mt][3], acc[mt][3]));
    }
  };

  auto compute = [&](int slot) {
    const uint32_t st = smem_a + slot * L::STAGE;
    const float* ss = reinterpret_cast<const float*>(smem + slot * L::STAGE + L::SCALE);
    const float* bs = reinterpret_cast<const float*>(smem + slot * L::STAGE + L::BIAS);
    const uint32_t xrow = st + xrow_off;
    // codes of the warp's 16 columns: [chunk of 16 rows][rows 0-7, rows 8-15]
    constexpr int CH = L::ROWS / 16;
    uint32_t cw[CH][2];
#pragma unroll
    for (int p = 0; p < CH / 2; ++p) {
      const unsigned r = 32 * p + lane;
      ldsm_x4_trans(st + L::CODES + r * L::BN + ((warp ^ L::swz(r)) << 4), cw[2 * p][0],
                    cw[2 * p][1], cw[2 * p + 1][0], cw[2 * p + 1][1]);
    }
    if constexpr (FMT == PACKED4) {
      // each half's 4 chunks of 16 rows in GPS groups of CPG chunks
      constexpr int CPG = 4 / L::GPS;
#pragma unroll
      for (int gi = 0; gi < L::GPS; ++gi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float tq[MT][4], t1[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j) tq[mt][j] = t1[mt][j] = 0.0f;
#pragma unroll
          for (int cc = 0; cc < CPG; ++cc) {
            const int ch = CPG * gi + cc;
            // one mask-and-or (lop3) makes each bf16 pair
            const uint32_t a0 = nib_pair(cw[ch][0] >> (4 * h));
            const uint32_t a1 = nib_pair(cw[ch][0] >> (8 + 4 * h));
            const uint32_t a2 = nib_pair(cw[ch][1] >> (4 * h));
            const uint32_t a3 = nib_pair(cw[ch][1] >> (8 + 4 * h));
            uint32_t b[2][2];
            x_frag(xrow + h * 128 + ch * 32, b);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(tq[mt], a0, a1, a2, a3, b[mt][0], b[mt][1]);
              mma_bf16(t1[mt], BF16_ONES, BF16_ONES, BF16_ONES, BF16_ONES, b[mt][0], b[mt][1]);
            }
          }
          apply(ss, bs, h * L::GPS + gi, 128.0f, tq, t1);
        }
      }
    } else if constexpr (FMT == E4M3) {
#pragma unroll
      for (int gi = 0; gi < L::GROUPS; ++gi) {
        float tq[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) tq[mt][j] = 0.0f;
#pragma unroll
        for (int cc = 0; cc < L::G / 16; ++cc) {
          const int ch = gi * (L::G / 16) + cc;
          // bytes 0, 2 are A row g (k 2q, 2q+1), bytes 1, 3 row g + 8
          const float4 p = e4m3x4(cw[ch][0]), r = e4m3x4(cw[ch][1]);
          const uint32_t a0 = pack_bf16(p.x, p.z), a1 = pack_bf16(p.y, p.w);
          const uint32_t a2 = pack_bf16(r.x, r.z), a3 = pack_bf16(r.y, r.w);
          uint32_t b[2][2];
          x_frag(xrow + ch * 32, b);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(tq[mt], a0, a1, a2, a3, b[mt][0], b[mt][1]);
        }
        const float2 s2 = *reinterpret_cast<const float2*>(ss + gi * L::BN + 16 * warp + 2 * g);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][0] = fmaf(s2.x, tq[mt][0], acc[mt][0]);
          acc[mt][1] = fmaf(s2.x, tq[mt][1], acc[mt][1]);
          acc[mt][2] = fmaf(s2.y, tq[mt][2], acc[mt][2]);
          acc[mt][3] = fmaf(s2.y, tq[mt][3], acc[mt][3]);
        }
      }
    } else {
      constexpr float OFF = FMT == S8 ? 2304.0f : 2176.0f;
#pragma unroll
      for (int gi = 0; gi < L::GROUPS; ++gi) {
        float tq[MT][4], t1[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) tq[mt][j] = t1[mt][j] = 0.0f;
#pragma unroll
        for (int cc = 0; cc < L::G / 16; ++cc) {
          const int ch = gi * (L::G / 16) + cc;
          uint32_t c0 = cw[ch][0], c1 = cw[ch][1];
          if (FMT == S8) {  // signed q -> u = q + 128
            c0 ^= 0x80808080u;
            c1 ^= 0x80808080u;
          }
          // bytes 0, 2 are A row g (k 2q, 2q+1), bytes 1, 3 row g + 8
          const uint32_t l0 = nib_pair(c0), l1 = nib_pair(c0 >> 8);
          const uint32_t l2 = nib_pair(c1), l3 = nib_pair(c1 >> 8);
          const uint32_t h0 = nib_pair_x16(c0 >> 4), h1 = nib_pair_x16(c0 >> 12);
          const uint32_t h2 = nib_pair_x16(c1 >> 4), h3 = nib_pair_x16(c1 >> 12);
          uint32_t b[2][2];
          x_frag(xrow + ch * 32, b);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(tq[mt], l0, l1, l2, l3, b[mt][0], b[mt][1]);
            mma_bf16(tq[mt], h0, h1, h2, h3, b[mt][0], b[mt][1]);
            mma_bf16(t1[mt], BF16_ONES, BF16_ONES, BF16_ONES, BF16_ONES, b[mt][0], b[mt][1]);
          }
        }
        apply(ss, bs, gi, OFF, tq, t1);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < D_STAGES - 1; ++i) {
    if (i < n) load(i, s_begin + i);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    cp_async_wait<D_STAGES - 2>();
    __syncthreads();
    const int j = it + D_STAGES - 1;
    if (j < n) load(j % D_STAGES, s_begin + j);
    cp_async_commit();
    compute(it % D_STAGES);
  }
  cp_async_wait<0>();

  // lane (g, q) holds (column na, rows 8 mt + 2q, +1) in acc[mt][0..1] and
  // (column na + 1, the same rows) in acc[mt][2..3]
  const int q = lane & 3;
  const int na = n0 + 16 * warp + 2 * g;
  if (splits == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = 8 * mt + 2 * q + j;
        if (m < rows && na < N)
          store_pair(out, (size_t)(m0 + m) * N + na, acc[mt][j], acc[mt][2 + j], out_bf16);
      }
    return;
  }
  float* part = ws + (size_t)split * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = 8 * mt + 2 * q + j;
      if (m < rows && na < N)
        *reinterpret_cast<float2*>(part + (size_t)m * N + na) =
            make_float2(acc[mt][j], acc[mt][2 + j]);
    }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = 8 * mt + 2 * q + j;
      if (m < rows && na < N) {
        float2 sum = make_float2(0.0f, 0.0f);
        for (int sp = 0; sp < splits; ++sp) {
          const float2 v =
              __ldcg(reinterpret_cast<const float2*>(ws + ((size_t)sp * M + m) * N + na));
          sum.x += v.x;
          sum.y += v.y;
        }
        store_pair(out, (size_t)m * N + na, sum.x, sum.y, out_bf16);
      }
    }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next call
}

struct DecodeArgs {
  const __nv_bfloat16* x;
  const uint8_t* codes;
  const float* scale;
  const float* bias;
  void* out;
  int M, N, K, out_bf16, splits;
  const int* tile_idx;
  const int* n_used;
  long long code_stride, sb_stride;
  float* ws;
  int* counters;
  int gs;  // the group size (the runtime one of GS = 0)
};

// Launch the decode body; returns the error of the shared-memory opt-in
// (above 48 KB), if any. The launch's own error is the caller's
// cudaGetLastError().
template <int FMT, int MT, bool HB, int GS, int NW>
cudaError_t launch_decode(const DecodeArgs& a, cudaStream_t st) {
  using L = Decode<FMT, MT, HB, GS, NW>;
  auto kernel = mm_decode_kernel<FMT, MT, HB, GS, NW>;
  if (L::TOTAL > 48 * 1024) {
    static cudaError_t opt_in =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::TOTAL);
    if (opt_in != cudaSuccess) return opt_in;
  }
  const dim3 grid((a.N + L::BN - 1) / L::BN, a.tile_idx ? a.M / 16 : a.splits);
  kernel<<<grid, L::THREADS, L::TOTAL, st>>>(a.x, a.codes, a.scale, a.bias, a.out, a.M, a.N, a.K,
                                            a.out_bf16, a.splits, a.tile_idx, a.n_used,
                                            a.code_stride, a.sb_stride, a.ws, a.counters,
                                            a.gs);
  return cudaSuccess;
}

}  // namespace
