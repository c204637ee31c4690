// W4 dequant-matmul for Hopper (sm_90a): split-half packed 4-bit Q4_K codes.
//
// Replaces the TPU kernels of mistralrs_tpu/ops/quant_matmul.py:
//   _w4_matmul (:350), _w4_matmul_l (:527) and _w4_matmul_g (:830), body
//   _w4_kernel (:182) with _deq_dot (:106).
//
//   out[m, n] = sum_k x[m, k] * (scale[k / gs, n] * q[k, n] + bias[k / gs, n])
//
// Codes are [K/2, N] uint8: byte row r holds k = r in its low nibble and
// k = K/2 + r in its high nibble, so a step over byte rows [r0, r1)
// contracts two column ranges of x: [r0, r1) and [K/2 + r0, K/2 + r1).
// Scale and bias planes are f32 [K/gs, N]; bias may be absent. Groups of 32
// (Q4_K, Q4_0, Q4_1), of 16 (Q2_K: 2-bit codes in the nibbles), or of 64 or
// 128 (GPTQ, AWQ) that divide K/2, so that each half of the codes holds
// whole groups, for one matrix and a bank alike. The grouped
// form multiplies row tile t by expert tile_idx[t] of a bank (planes
// code_stride bytes and sb_stride floats apart); tiles at or past *n_used
// write zeros and read no weights.
//
// Two bodies, chosen by the wrapper's w4_plan (ops/quant_matmul.py):
//
// DECODE (a row tile of at most 16 rows: dense M <= 16, grouped tm = 16).
//   The body of csrc/mm_decode.cuh in its PACKED4 format, which it shares
//   with the W8 kernel (csrc/w8_matmul.cu): split K, a 4-stage cp.async
//   ring, mma.sync with the weight as the 16-row operand, scale and bias
//   applied to f32 group sums. That file says how it is built.
//
// PREFILL (a row tile of 64 or 128 rows: dense M > 16, grouped tm = 64).
//   Bound: the bf16 tensor-core rate; wgmma is the only way to it on Hopper.
//   A step is 32 byte rows: x's columns [32 s, 32 s + 32) and
//   [K/2 + 32 s, ...) side by side as one 64-column box, each half within
//   one group: plane rows 32 s / gs and (K/2 + 32 s) / gs (consecutive
//   steps read the same rows when gs > 32). At group 16 each half spans two
//   groups: a stage holds four plane rows (2 s, 2 s + 1 and their high-half
//   rows), and a consumer dequantizes byte rows 0-15 and 16-31 of a half
//   with the scale and bias of each one's own group; the ring holds one
//   stage fewer for 64-row tiles (6), as the stages are larger.
//   - Two producer warps and two consumer warpgroups; a block owns 128 rows
//     (a warpgroup each, 64 x 256) or 64 rows (grouped, or M <= 64: each
//     warpgroup takes 128 of the 256 columns, so eight warps still share the
//     dequantization) and 256 columns, wide so that x, re-read from L2 for
//     every column tile, costs less per product. Row tiles vary fastest in
//     the grid, so blocks that share a weight tile run together.
//   - The producers keep a ring of 5 (7 for 64-row tiles) stages of x, raw
//     codes, scales and biases in flight with cp.async.cg, each stage
//     signalled by cp.async.mbarrier.arrive on a "full" mbarrier; consumers
//     free a stage on an "empty" mbarrier.
//   - Consumers dequantize a stage's codes into a bf16 B tile [64 k x 256 n]
//     in shared memory, N-major in the 128-byte swizzle (read through
//     wgmma's transpose bit), while the wgmma of the previous stage runs (two
//     B buffers). One mask-and-or turns two nibbles into the exact bf16 pair
//     (128 + q0, 128 + q1); each half widens to f32 by a shift or a mask, and
//     w = fma(s, 128 + q, b - 128 s) is s q + b within an f32 ulp, rounded to
//     bf16 as the plain version rounds it. The stores are made visible to
//     wgmma with fence.proxy.async.shared::cta and a named barrier.
//   - x lands in the 128-byte swizzled K-major layout; each consumer
//     warpgroup runs wgmma.mma_async m64n256k16 (m64n128k16 for 64-row
//     tiles; bf16 in, f32 accumulators in registers) over its part. The
//     output tile is staged in the drained ring and stored in 16-byte rows.
//   - What still bounds it is the dequantization (PERF.md): it does not
//     overlap the wgmma as planned, and takes about as long.
//
// Both bodies need K % 128 == 0 and N % 16 == 0 (checked by the wrapper and
// here); columns past N and rows past M are zero-filled, never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mm_decode.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// PREFILL body: producer warpgroup, mbarrier ring, wgmma
// ---------------------------------------------------------------------------

constexpr int P_BN = 256;       // output columns per block
constexpr int P_PRODUCERS = 64;  // two producer warps

// Two consumer warpgroups: for a 128-row tile each takes 64 rows and all
// 256 columns; for a 64-row tile each takes the 64 rows and 128 columns.
// SUB plane rows a half per step: 2 at group 16, else 1.
template <int BM_, int SUB_>
struct PrefillSmem {
  static constexpr int BM = BM_;
  static constexpr int SUB = SUB_;
  static constexpr int WN = BM == 128 ? 256 : 128;  // columns per warpgroup
  static constexpr int STAGES = BM == 128 ? 5 : (SUB == 2 ? 6 : 7);
  // a step is 32 byte rows: logical k = [lo 32 | hi 32], SUB groups each
  static constexpr int X = 0;                        // [BM][64 k = 128 B], SW128
  static constexpr int CODES = BM * 128;             // [32 byte rows][256 B]
  // [2 SUB rows: the low half's groups, then the high half's][256] f32
  static constexpr int SCALE = CODES + 32 * P_BN;
  static constexpr int BIAS = SCALE + 2 * SUB * P_BN * 4;
  static constexpr int STAGE = BIAS + 2 * SUB * P_BN * 4;  // a multiple of 1024
  static constexpr int BT = P_BN * 128;              // B tile [64 k][256 n], N-major SW128
  static constexpr int BTILES = STAGES * STAGE;
  static constexpr int BARS = BTILES + 2 * BT;
  static constexpr int TOTAL = BARS + 2 * STAGES * 8 + 1024;  // + alignment slack
  static_assert(BM * (P_BN * 4 + 16) <= BTILES, "the f32 output tile must fit the drained ring");
  static constexpr int THREADS = 256 + P_PRODUCERS;
  static_assert(STAGE % 1024 == 0, "stages must keep the 1024-byte swizzle alignment");
};

// the B tile's N-major 128-byte swizzle (sw128_desc, wgmma.cuh): 1024-byte
// atoms of 8 k rows x 64 n, the atoms of the next 8 k sbo = 1024 B on, those
// of the next 64 n lbo = 8192 B on
constexpr uint32_t B_LBO = 8192, B_SBO = 1024;

// GS = 0: groups of 64 or 128, the plane rows by a runtime shift (a bank's
// planes offset to its expert first); GS = 32: one row a half a step; GS =
// 16: two rows a half a step
template <int BM, bool HAS_BIAS, int GS>
__global__ void __launch_bounds__(256 + P_PRODUCERS, 1)
w4_prefill_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  void* __restrict__ out, int M, int N, int K, int out_bf16,
                  const int* __restrict__ tile_idx, const int* __restrict__ n_used,
                  long long code_stride, long long sb_stride, int gs) {
  constexpr int SUB = GS == 16 ? 2 : 1;
  using L = PrefillSmem<BM, SUB>;
  constexpr int WN = L::WN;
  extern __shared__ uint8_t dsmem[];
  const uint32_t raw = smem_u32(dsmem);
  uint8_t* smem = dsmem + ((1024 - (raw & 1023)) & 1023);
  const uint32_t smem_a = smem_u32(smem);
  const int tid = threadIdx.x;
  // row tiles vary fastest, so the blocks that share a weight tile run
  // together and find it in L2
  const int n0 = blockIdx.y * P_BN, m0 = blockIdx.x * L::BM;
  if (tile_idx != nullptr) {
    if ((int)blockIdx.x >= *n_used) {
      zero_tile(out, m0, L::BM, n0, P_BN, N, out_bf16);
      return;
    }
    const long long e = tile_idx[blockIdx.x];
    codes += e * code_stride;
    scale += e * sb_stride;
    if (HAS_BIAS) bias += e * sb_stride;
  }
  // a step's plane rows by a shift of its index (steps of 32 rows; gs 64
  // or 128 when GS = 0), no division in the producers' loop; gh: the first
  // plane row of the high half
  const int gsh = GS == 0 ? __ffs(gs) - 6 : 0;
  const int kh = K / 2, gh = SUB == 2 ? kh >> 4 : (kh >> 5) >> gsh, nsteps = kh / 32;
  const uint32_t full = smem_a + L::BARS, empty = full + 8 * L::STAGES;
  if (tid == 0) {
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(full + 8 * i, P_PRODUCERS);  // one cp.async arrival per producer thread
      mbar_init(empty + 8 * i, 8);           // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // producer warps
    const int p = tid - 256;
    for (int s = 0; s < nsteps; ++s) {
      const int slot = s % L::STAGES;
      mbar_wait(empty + 8 * slot, ((s / L::STAGES) & 1) ^ 1);
      const uint32_t st = smem_a + slot * L::STAGE;
      // x: rows m0.., chunks 0-3 from the low half, 4-7 from the high half;
      // chunk c of row r at c ^ (r % 8) (the 128-byte swizzle wgmma reads)
      for (int i = p; i < 8 * L::BM; i += P_PRODUCERS) {
        const int r = i >> 3, c = i & 7;
        const bool ok = m0 + r < M;
        const int k = (c < 4 ? 0 : kh - 32) + s * 32 + c * 8;
        cp_async16(st + L::X + r * 128 + ((c ^ (r & 7)) << 4),
                   x + (ok ? (size_t)(m0 + r) * K + k : 0), ok);
      }
      // codes: 32 byte rows x 16 chunks of 16 columns
      for (int i = p; i < 32 * 16; i += P_PRODUCERS) {
        const int r = i >> 4, j = i & 15;
        const int col = n0 + 16 * j;
        const bool ok = col < N;
        cp_async16(st + L::CODES + r * 256 + (j << 4),
                   codes + (ok ? (size_t)(s * 32 + r) * N + col : 0), ok);
      }
      const int g0 = SUB == 2 ? 2 * s : s >> gsh;
      for (int i = p; i < 2 * SUB * 64; i += P_PRODUCERS) {
        // g: SUB rows of the low half, then SUB of the high half
        const int g = i >> 6, c = i & 63;
        const int grow = (g >= SUB ? gh : 0) + g0 + (SUB == 2 ? (g & 1) : 0);
        const int col = n0 + 4 * c;
        const bool ok = col < N;
        cp_async16(st + L::SCALE + (g * P_BN + 4 * c) * 4,
                   scale + (ok ? (size_t)grow * N + col : 0), ok);
        if (HAS_BIAS)
          cp_async16(st + L::BIAS + (g * P_BN + 4 * c) * 4,
                     bias + (ok ? (size_t)grow * N + col : 0), ok);
      }
      cp_async_mbar_arrive(full + 8 * slot);
    }
    cp_async_wait<0>();
    return;
  }

  // consumer warpgroups: wg's rows start at xr, its B columns at wc
  const int cwarp = tid >> 5, lane = tid & 31, wg = tid >> 7;
  const int xr = BM == 128 ? 64 * wg : 0, wc = BM == 128 ? 0 : WN * wg;
  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.0f;

  // Dequantize stage `slot` into B tile `buf`. Lane l owns columns
  // 8 l..8 l+7 and warp w byte rows w, w + 8, ... (at group 16: rows w, w +
  // 8 with the first group's scale and bias, then w + 16, w + 24 with the
  // second's); a 32-bit code word
  // holds columns n0..n0+3 of a byte row, and one mask-and-or turns the
  // nibbles of columns (n0, n0+2) or (n0+1, n0+3) into the bf16 pair
  // (128 + q0, 128 + q2), so the B tile keeps each 8 columns in the order
  // 0 2 1 3 4 6 5 7 (undone in the epilogue). Each half widens to an exact
  // f32 128 + q, and w = fma(s, 128 + q, b - 128 s) is s q + b within an f32
  // ulp before the same rounding to bf16 as the plain version's.
  const int n8 = 8 * lane;
  auto dequant = [&](int slot, int buf) {
    const uint8_t* st = smem + slot * L::STAGE;
    const float* ss = reinterpret_cast<const float*>(st + L::SCALE);
    const float* bs = reinterpret_cast<const float*>(st + L::BIAS);
    const uint32_t bt = smem_a + L::BTILES + buf * L::BT;
    // N-major SW128 address of (k, this lane's 8 columns)
    const uint32_t col_off = (n8 >> 6) * B_LBO;
    const int chunk = (n8 >> 3) & 7;
#pragma unroll
    for (int hs = 0; hs < 2 * SUB; ++hs) {
      const int h = hs / SUB, row0 = (hs % SUB) * (32 / SUB);  // the half; its first byte row
      float sc[8], bc[8];  // in the B column order 0 2 1 3 4 6 5 7
      {
        const float4 sa = *reinterpret_cast<const float4*>(ss + hs * P_BN + n8);
        const float4 sb = *reinterpret_cast<const float4*>(ss + hs * P_BN + n8 + 4);
        float4 ba = make_float4(0.0f, 0.0f, 0.0f, 0.0f), bb = ba;
        if (HAS_BIAS) {
          ba = *reinterpret_cast<const float4*>(bs + hs * P_BN + n8);
          bb = *reinterpret_cast<const float4*>(bs + hs * P_BN + n8 + 4);
        }
        const float sv[8] = {sa.x, sa.z, sa.y, sa.w, sb.x, sb.z, sb.y, sb.w};
        const float bv[8] = {ba.x, ba.z, ba.y, ba.w, bb.x, bb.z, bb.y, bb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          sc[i] = sv[i];
          bc[i] = fmaf(-128.0f, sv[i], bv[i]);
        }
      }
#pragma unroll 2
      for (int r = row0 + cwarp; r < row0 + 32 / SUB; r += 8) {
        const uint2 cw = *reinterpret_cast<const uint2*>(st + L::CODES + r * 256 + n8);
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t word = i < 2 ? cw.x : cw.y;
          const uint32_t pr = nib_pair(word >> ((i & 1) * 8 + 4 * h));
          const float lo = fmaf(sc[2 * i], __uint_as_float(pr << 16), bc[2 * i]);
          const float hi = fmaf(sc[2 * i + 1], __uint_as_float(pr & 0xFFFF0000u), bc[2 * i + 1]);
          v[i] = pack_bf16(lo, hi);
        }
        const int k = 32 * h + r;
        const uint32_t addr = bt + col_off + (k >> 3) * B_SBO + (k & 7) * 128 + ((chunk ^ (k & 7)) << 4);
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v[0]),
                     "r"(v[1]), "r"(v[2]), "r"(v[3])
                     : "memory");
      }
    }
  };
  auto consumer_sync = [] { asm volatile("bar.sync 1, 256;\n" ::: "memory"); };

  mbar_wait(full, 0);
  fence_proxy_async();
  dequant(0, 0);
  fence_proxy_async();
  consumer_sync();
  for (int s = 0; s < nsteps; ++s) {
    const int slot = s % L::STAGES, buf = s & 1;
    const uint32_t xa = smem_a + slot * L::STAGE + L::X + xr * 128;
    const uint32_t ba = smem_a + L::BTILES + buf * L::BT + (wc / 64) * B_LBO;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tile<WN>(acc, sw128_desc(xa + kk * 32, 16, 1024),
                     sw128_desc(ba + kk * 2 * B_SBO, B_LBO, B_SBO));
    wgmma_commit();
    if (s + 1 < nsteps) {
      const int ns = (s + 1) % L::STAGES;
      mbar_wait(full + 8 * ns, ((s + 1) / L::STAGES) & 1);
      fence_proxy_async();
      dequant(ns, buf ^ 1);
      fence_proxy_async();
    }
    wgmma_wait0();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
    consumer_sync();
  }

  // Epilogue: the ring is drained (every stage was waited for), so the tile
  // is staged there row-major, columns back in order, and written out in
  // 16-byte chunks. Lane (g, q) of warp wi holds rows xr + 16 wi + g (+8)
  // and B columns wc + 8 j + 2 q (+1), which are columns wc + 8 j + c and
  // wc + 8 j + c + 2 of out with c = (q & 1) + 4 (q >> 1) (the dequantizer's
  // column order).
  const int wi = cwarp & 3, g = lane >> 2, q = lane & 3;
  const int cq = (q & 1) + 4 * (q >> 1);
  const int esz = out_bf16 ? 2 : 4;
  const int pitch = P_BN * esz + 16;
#pragma unroll
  for (int jn = 0; jn < WN / 8; ++jn)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = xr + 16 * wi + g + 8 * hr, col = wc + 8 * jn + cq;
      uint8_t* at = smem + row * pitch + col * esz;
      const float a = acc[4 * jn + 2 * hr], b = acc[4 * jn + 2 * hr + 1];
      if (out_bf16) {
        reinterpret_cast<__nv_bfloat16*>(at)[0] = __float2bfloat16_rn(a);
        reinterpret_cast<__nv_bfloat16*>(at)[2] = __float2bfloat16_rn(b);
      } else {
        reinterpret_cast<float*>(at)[0] = a;
        reinterpret_cast<float*>(at)[2] = b;
      }
    }
  consumer_sync();
  const int chunks = P_BN * esz / 16;  // per row
  for (int i = tid; i < BM * chunks; i += 256) {
    const int row = i / chunks, c = i % chunks;
    const int m = m0 + row, col = n0 + c * 16 / esz;
    if (m < M && col < N)
      *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(out) + ((size_t)m * N + col) * esz) =
          *reinterpret_cast<const uint4*>(smem + row * pitch + c * 16);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

using Args = DecodeArgs;

template <int BM, bool HB, int GS>
void launch_prefill(const Args& a, cudaStream_t st) {
  using L = PrefillSmem<BM, GS == 16 ? 2 : 1>;
  auto kernel = w4_prefill_kernel<BM, HB, GS>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::TOTAL);
  const dim3 grid((a.M + L::BM - 1) / L::BM, (a.N + P_BN - 1) / P_BN);
  kernel<<<grid, L::THREADS, L::TOTAL, st>>>(a.x, a.codes, a.scale, a.bias, a.out, a.M, a.N, a.K,
                                             a.out_bf16, a.tile_idx, a.n_used, a.code_stride,
                                             a.sb_stride, a.gs);
}

// returns cudaErrorInvalidValue for a body and tile it does not have; GS
// 16 or 32, or 0 for groups over 32 (both bodies' runtime-group forms)
template <bool HB, int GS>
cudaError_t launch(const Args& a, int body, int tile, cudaStream_t st) {
  if (body == 0 && tile == 8) return launch_decode<PACKED4, 1, HB, GS, 4>(a, st);
  if (body == 0 && tile == 16) return launch_decode<PACKED4, 2, HB, GS, 4>(a, st);
  if (body == 1 && tile == 64) launch_prefill<64, HB, GS>(a, st);
  else if (body == 1 && tile == 128) launch_prefill<128, HB, GS>(a, st);
  else return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <bool HB>
cudaError_t launch_gs(const Args& a, int body, int tile, cudaStream_t st) {
  if (a.gs == 16) return launch<HB, 16>(a, body, tile, st);
  if (a.gs == 32) return launch<HB, 32>(a, body, tile, st);
  return launch<HB, 0>(a, body, tile, st);
}

}  // namespace

// W4 matmul: x [M, K] bf16, codes [(E,) K/2, N] uint8, scale and bias
// [(E,) K/gs, N] f32 (bias may be NULL), out [M, N] (bf16 or f32); gs 16,
// 32, 64 or 128 dividing K/2.
// body 0 (decode): tile 8 or 16 rows; dense: M <= tile, grid.y = splits of
//   K, workspace f32 [splits, M, N] and counters int32 [ceil(N / 64)] (all
//   zero, left zero) when splits > 1; grouped: tile 16, one split.
// body 1 (prefill): tile 64 or 128 rows (grouped: 64), one split.
// Grouped when tile_idx is given: M / tile row tiles, tile_idx [M / tile]
// int32 experts, n_used one int32 on the device.
extern "C" int mrt_w4_matmul(const void* x, const void* codes, const void* scale,
                             const void* bias, void* out, const void* tile_idx,
                             const void* n_used, int M, int N, int K, int gs, int out_bf16,
                             int body, int tile, int splits, long long code_stride,
                             long long sb_stride, void* workspace, void* counters,
                             void* stream) {
  const bool grouped = tile_idx != nullptr;
  const int nsteps = K / 128;
  const bool ok = K > 0 && K % 128 == 0 && N > 0 && N % 16 == 0 && M > 0 && splits >= 1 &&
                  (gs == 16 || gs == 32 || gs == 64 || gs == 128) && (K / 2) % gs == 0 &&
                  splits <= nsteps &&
                  (grouped ? (n_used != nullptr && M % tile == 0 && splits == 1 &&
                              (body == 0 ? tile == 16 : tile == 64))
                           : (body == 1 || M <= tile)) &&
                  (splits == 1 || (workspace != nullptr && counters != nullptr && body == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
               static_cast<const float*>(scale), static_cast<const float*>(bias), out, M, N, K,
               out_bf16, splits, static_cast<const int*>(tile_idx),
               static_cast<const int*>(n_used), code_stride, sb_stride,
               static_cast<float*>(workspace), static_cast<int*>(counters), gs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bias ? launch_gs<true>(a, body, tile, st)
                             : launch_gs<false>(a, body, tile, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
