// Paged attention over a bf16 block-table KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernels of mistralrs_tpu/ops/paged_attention.py:
//   paged_decode_attention_fused (:496, body _decode_kernel :38) and
//   paged_prefill_attention_fused (:1162, body _prefill_kernel :525),
// for bf16 pools without window, softcap or sinks (the wrapper refuses those).
//
// Pool layout (one layer plane): [n_kv, S, hd] bf16, slot = block * bs + row.
// Both kernels write this step's K/V rows into the pools in place, then run
// an online-softmax (flash) attention in f32 with exp2 and log2(e) folded
// into the scale, the JAX kernels' math (ops/paged_attention.py: 31-35):
// exp2(log2e * x) == exp(x).
//
// Decode (one query token per sequence). Bound: device-memory bytes; it
// reads each sequence's K/V once (2 * kv_len * n_kv * hd * 2 B) for a
// handful of flops per byte. One block of 4 warps per (KV head, sequence);
// all query heads of the GQA group share the block, so each K/V row is read
// once per group. K/V move through shared memory 64 positions at a time
// (16-byte loads; the K tile's rows are padded to 130 elements so
// lane-per-position dot products are free of bank conflicts), and the
// scores use plain FMAs with the query pre-scaled in f32.
//
// Prefill (a chunk of T tokens on top of the cached past). Bound: the bf16
// tensor-core rate at the engine's chunks (causal work T * kv_len), so the
// body is FlashAttention-2 on mma.sync m16n8k16 (bf16 in, f32 accumulators):
// one block of 4 warps per (query tile of 64 rows, KV head, sequence), each
// warp 16 rows (token, head of the GQA group), its Q in registers as A
// fragments for the whole walk. K/V tiles of 64 positions are gathered
// through the block table (or from k_new/v_new for the chunk's own
// positions) into a cp.async double buffer, so the next tile's copy runs
// under this tile's math (a third stage measured no faster). S = Q K^T is
// masked per row only on the diagonal tiles; the online softmax keeps (m, l)
// per row in registers, applies scale * log2(e) to the f32 scores inside
// the exponent (one fma per score, ex2.approx) and rescales the O
// accumulators in registers. P enters O += P V (V read through
// ldmatrix.trans) as two bf16 A operands, hi = bf16(P) and lo = bf16(P -
// hi), so P keeps ~16 bits as the plain version's f32 P does: P rounded once
// to bf16 moved the Mixtral model's expert choices to the 99 % floor of
// chip_smoke.py's phase 3b. At these shapes the body is bound by
// instruction issue more than by the tensor cores, so the gather walks the
// block table by additions, not divisions. KV tiles past the query tile's
// last visible position are skipped, and later query tiles start first.
// Shared memory: two K/V stages of 32 KB (Q lands in the second one first),
// two blocks per SM (the registers allow no more). GQA groups dividing 64
// (1 to 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int HD = 128;      // head_dim (the wrapper requires it)
constexpr int TILE = 64;     // KV positions per shared-memory tile
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int KS_LD = HD + 2;   // bf16 elements; 65 words per row
constexpr float NEG_INF = -1e30f;
constexpr int DEC_MAX_GROUP = 16;               // decode: query heads per KV head
constexpr int DEC_HEADS_PER_WARP = DEC_MAX_GROUP / NWARPS;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Store one 16-byte chunk into a K-tile row (65-word stride, so as 4-byte
// words).
__device__ __forceinline__ void store_k_chunk(__nv_bfloat16* ks_row, int chunk, uint4 v) {
  uint32_t* w = reinterpret_cast<uint32_t*>(ks_row) + chunk * 4;
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// Load a TILE x HD tile of K and V into shared memory. `row_of(p, kp, vp)`
// sets the K and V row pointers of position p, or NULL when it is masked
// (the tile row is then zeros).
template <typename RowFn>
__device__ __forceinline__ void load_tile(__nv_bfloat16* ks, __nv_bfloat16* vs, int t0,
                                          RowFn row_of) {
  for (int i = threadIdx.x; i < TILE * (HD / 8); i += THREADS) {
    const int r = i / (HD / 8), ch = i - r * (HD / 8);
    const __nv_bfloat16* kp;
    const __nv_bfloat16* vp;
    row_of(t0 + r, kp, vp);
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (kp) {
      kv = reinterpret_cast<const uint4*>(kp)[ch];
      vv = reinterpret_cast<const uint4*>(vp)[ch];
    }
    store_k_chunk(ks + r * KS_LD, ch, kv);
    reinterpret_cast<uint4*>(vs + r * HD)[ch] = vv;
  }
}

__device__ __forceinline__ float dot_row(const float* q, const __nv_bfloat16* k_row) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(k_row);
  const float2* q2 = reinterpret_cast<const float2*>(q);
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD / 2; ++d) {
    const float2 kf = __bfloat1622float2(k2[d]);
    const float2 qf = q2[d];
    s = fmaf(qf.x, kf.x, s);
    s = fmaf(qf.y, kf.y, s);
  }
  return s;
}

__device__ __forceinline__ float4 v_quad(const __nv_bfloat16* vs, int j, int lane) {
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(vs + j * HD + lane * 4);
  const float2 a = __bfloat1622float2(v2[0]);
  const float2 b = __bfloat1622float2(v2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// ---------------------------------------------------------------------------
// decode: grid (n_kv, B), one query token per sequence
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* k_pool,
                    __nv_bfloat16* v_pool, const __nv_bfloat16* __restrict__ k_new,
                    const __nv_bfloat16* __restrict__ v_new, const int* __restrict__ slots,
                    const int* __restrict__ block_tables, const int* __restrict__ kv_lens,
                    __nv_bfloat16* __restrict__ out, int n_q, int n_kv, int S, int W,
                    int bs, float scale_log2) {
  __shared__ __align__(16) float qs[DEC_MAX_GROUP * HD];
  __shared__ __align__(16) __nv_bfloat16 ks[TILE * KS_LD];
  __shared__ __align__(16) __nv_bfloat16 vs[TILE * HD];
  __shared__ float ps[NWARPS][TILE];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = n_q / n_kv;
  const int kv_len = kv_lens[b];

  // 1. this step's K/V row → slots[b] (slot < 0: the write is dropped)
  const int slot = slots[b];
  if (slot >= 0) {
    const size_t src = ((size_t)b * n_kv + h) * HD;
    const size_t dst = ((size_t)h * S + slot) * HD;
    for (int d = tid; d < HD; d += THREADS) {
      k_pool[dst + d] = k_new[src + d];
      v_pool[dst + d] = v_new[src + d];
    }
  }
  // 2. the group's queries, pre-scaled into the log2 domain
  for (int i = tid; i < group * HD; i += THREADS)
    qs[i] = __bfloat162float(q[((size_t)b * n_q + h * group) * HD + i]) * scale_log2;
  __syncthreads();  // the write above is visible to the reads below

  float m[DEC_HEADS_PER_WARP], l[DEC_HEADS_PER_WARP], acc[DEC_HEADS_PER_WARP][4];
#pragma unroll
  for (int i = 0; i < DEC_HEADS_PER_WARP; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  const int* table = block_tables + (size_t)b * W;
  auto row_of = [&](int p, const __nv_bfloat16*& kp, const __nv_bfloat16*& vp) {
    if (p < kv_len) {
      const size_t off = ((size_t)h * S + (size_t)table[p / bs] * bs + p % bs) * HD;
      kp = k_pool + off;
      vp = v_pool + off;
    } else {
      kp = vp = nullptr;
    }
  };
  for (int t0 = 0; t0 < kv_len; t0 += TILE) {
    load_tile(ks, vs, t0, row_of);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DEC_HEADS_PER_WARP; ++i) {
      const int g = warp + i * NWARPS;
      if (g >= group) break;
      float s0 = dot_row(qs + g * HD, ks + lane * KS_LD);
      float s1 = dot_row(qs + g * HD, ks + (lane + 32) * KS_LD);
      if (t0 + lane >= kv_len) s0 = NEG_INF;
      if (t0 + lane + 32 >= kv_len) s1 = NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      const float alpha = exp2f(m[i] - m_new);
      const float p0 = s0 > 0.5f * NEG_INF ? exp2f(s0 - m_new) : 0.f;
      const float p1 = s1 > 0.5f * NEG_INF ? exp2f(s1 - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p0 + p1);
      m[i] = m_new;
      ps[warp][lane] = p0;
      ps[warp][lane + 32] = p1;
      __syncwarp();
      float a0 = acc[i][0] * alpha, a1 = acc[i][1] * alpha;
      float a2 = acc[i][2] * alpha, a3 = acc[i][3] * alpha;
      for (int j = 0; j < TILE; ++j) {
        const float pj = ps[warp][j];
        const float4 v = v_quad(vs, j, lane);
        a0 = fmaf(pj, v.x, a0);
        a1 = fmaf(pj, v.y, a1);
        a2 = fmaf(pj, v.z, a2);
        a3 = fmaf(pj, v.w, a3);
      }
      acc[i][0] = a0; acc[i][1] = a1; acc[i][2] = a2; acc[i][3] = a3;
      __syncwarp();
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < DEC_HEADS_PER_WARP; ++i) {
    const int g = warp + i * NWARPS;
    if (g >= group) break;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    __nv_bfloat16* o = out + ((size_t)b * n_q + h * group + g) * HD + lane * 4;
    o[0] = __float2bfloat16_rn(acc[i][0] * inv);
    o[1] = __float2bfloat16_rn(acc[i][1] * inv);
    o[2] = __float2bfloat16_rn(acc[i][2] * inv);
    o[3] = __float2bfloat16_rn(acc[i][3] * inv);
  }
}

// ---------------------------------------------------------------------------
// prefill: FlashAttention-2 style on the tensor cores. grid (query tiles, n_kv,
// B); a tile is FA_ROWS = qtok * group query rows (row R -> token
// qt * qtok + R / group, head R % group), each warp 16 of them.
// ---------------------------------------------------------------------------

constexpr int FA_ROWS = 64;                  // query rows per block (4 warps x 16)
constexpr int FA_TILE = 64;                  // KV positions per tile
constexpr int FA_STAGES = 2;                 // K/V tiles in the cp.async ring
constexpr int FA_ROW_B = HD * 2;             // 256 bytes per row of Q, K or V
constexpr int FA_KV_B = FA_TILE * FA_ROW_B;  // one K or V tile (16 KB)
constexpr int FA_STAGE_B = 2 * FA_KV_B;      // a stage: the K tile, then the V tile
// Q lands in the last stage's K tile, is read into registers, and that stage
// is then filled like the others; the output is staged there at the end
constexpr int FA_Q = (FA_STAGES - 1) * FA_STAGE_B;
constexpr int FA_SMEM = FA_STAGES * FA_STAGE_B;  // 64 KB
static_assert(FA_ROWS * FA_ROW_B <= FA_KV_B, "Q must fit a K tile");

// 2^x (the MUFU instruction; denormal results flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte chunk c (8 head dims) of row r in a [rows][256 B]
// tile: chunks XOR-swizzled by r % 8, so the 8 rows an ldmatrix reads at
// one logical chunk lie in 8 different bank groups
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * FA_ROW_B + ((c ^ (r & 7)) << 4));
}

__global__ void __launch_bounds__(THREADS, 2)
paged_prefill_kernel(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* k_pool,
                     __nv_bfloat16* v_pool, const __nv_bfloat16* __restrict__ k_new,
                     const __nv_bfloat16* __restrict__ v_new, const int* __restrict__ slots,
                     const int* __restrict__ block_tables, const int* __restrict__ kv_lens,
                     const int* __restrict__ n_valid_arr, __nv_bfloat16* __restrict__ out,
                     int T, int n_q, int n_kv, int S, int W, int bs, float scale_log2) {
  extern __shared__ __align__(128) uint8_t fa_smem[];
  const uint32_t sa = smem_u32(fa_smem);
  // later query tiles see more positions: they start first
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int group = n_q / n_kv;
  const int qtok = FA_ROWS / group;
  const int t_begin = qt * qtok;
  const int kv_len = kv_lens[b];
  const int nv = n_valid_arr[b];
  const int ctx = kv_len - nv;  // past tokens already in the pool

  // 1. write this tile's tokens' K/V rows (t < n_valid, slot >= 0). The
  // rows read below never touch these slots: positions >= ctx come from
  // k_new/v_new, so no block of this launch reads a slot another one writes.
  for (int i = tid; i < qtok * (HD / 8); i += THREADS) {
    const int t = t_begin + (i >> 4), c = i & 15;
    if (t >= T || t >= nv) continue;
    const int slot = slots[(size_t)b * T + t];
    if (slot < 0) continue;
    const size_t src = (((size_t)b * T + t) * n_kv + h) * HD + c * 8;
    const size_t dst = ((size_t)h * S + slot) * HD + c * 8;
    *reinterpret_cast<uint4*>(k_pool + dst) = *reinterpret_cast<const uint4*>(k_new + src);
    *reinterpret_cast<uint4*>(v_pool + dst) = *reinterpret_cast<const uint4*>(v_new + src);
  }
  // 2. the tile's queries into shared memory (rows past T: zeros)
  for (int i = tid; i < FA_ROWS * (HD / 8); i += THREADS) {
    const int r = i >> 4, c = i & 15;
    const int t = t_begin + r / group;
    const bool ok = t < T;
    cp_async16(sa + FA_Q + swz(r, c),
               q + (ok ? (((size_t)b * T + t) * n_q + h * group + r % group) * HD + c * 8 : 0),
               ok);
  }
  cp_async_commit();

  // Each row's last visible position: its own (ctx + t) for valid tokens;
  // rows past n_valid see the whole cache (their output is never read).
  // block_lim is the tile's largest, min_lim its smallest (row 0's): KV
  // tiles past block_lim are skipped (a tile with no valid token reads
  // nothing and writes zeros), tiles wholly at or below min_lim need no mask.
  const int last_valid_t = min(t_begin + qtok, nv) - 1;
  const int block_lim = t_begin >= nv ? -1
                        : (t_begin + qtok <= nv) ? ctx + last_valid_t : kv_len - 1;
  const int min_lim = ctx + t_begin;
  int lim[2];  // this lane's rows 16 warp + g and + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t_begin + (16 * warp + g + 8 * i) / group;
    lim[i] = t < nv ? ctx + t : kv_len - 1;
  }
  const int n_tiles = block_lim < 0 ? 0 : block_lim / FA_TILE + 1;

  // The next K/V tile (positions [p0, p0 + 64), tiles loaded in order) into
  // slot buf, gathered through the block table (positions < ctx) or from
  // k_new/v_new (>= ctx); rows past block_lim are zero-filled. Thread: chunk
  // tid % 16 of rows tid / 16 + 8 j; (blk, off) is its first row's table
  // entry and offset in the block, advanced by additions, not divisions.
  const int* table = block_tables + (size_t)b * W;
  const size_t pool_h = (size_t)h * S;
  int blk = (tid >> 4) / bs, off0 = (tid >> 4) % bs;
  auto load_kv = [&](int buf, int p0) {
    const int c = tid & 15;
    int bj = blk, oj = off0;
#pragma unroll
    for (int j = 0; j < FA_TILE / 8; ++j) {
      const int r = (tid >> 4) + 8 * j, p = p0 + r;
      const bool ok = p <= block_lim;
      const __nv_bfloat16* kb = k_pool;
      const __nv_bfloat16* vb = v_pool;
      size_t off = 0;
      if (ok) {
        if (p < ctx) {
          off = (pool_h + (size_t)table[bj] * bs + oj) * HD;
        } else {
          off = (((size_t)b * T + (p - ctx)) * n_kv + h) * HD;
          kb = k_new;
          vb = v_new;
        }
      }
      cp_async16(sa + buf * FA_STAGE_B + swz(r, c), kb + off + c * 8, ok);
      cp_async16(sa + buf * FA_STAGE_B + FA_KV_B + swz(r, c), vb + off + c * 8, ok);
      for (oj += 8; oj >= bs; oj -= bs) ++bj;
    }
    for (off0 += FA_TILE; off0 >= bs; off0 -= bs) ++blk;
  };

  float o[HD / 8][4];  // [16 x 128] output rows of the warp, f32
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  uint32_t qf[HD / 16][4];  // Q as A fragments, 8 chunks of 16 head dims

#pragma unroll
  for (int i = 0; i < FA_STAGES - 1; ++i) {
    if (i < n_tiles) load_kv(i, i * FA_TILE);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<FA_STAGES - 2>();  // Q and this tile have landed
    __syncthreads();  // ... for every thread; the slot refilled below is free
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc)
        ldsm_x4(sa + FA_Q + swz(16 * warp + (lane & 15), 2 * kc + (lane >> 4)), qf[kc][0],
                qf[kc][1], qf[kc][2], qf[kc][3]);
      __syncthreads();  // Q's slot is refilled next
    }
    const int nxt = it + FA_STAGES - 1;
    if (nxt < n_tiles) load_kv(nxt % FA_STAGES, nxt * FA_TILE);
    cp_async_commit();
    const uint32_t kt = sa + (it % FA_STAGES) * FA_STAGE_B, vt = kt + FA_KV_B;

    // S = Q K^T: [16 rows x 64 positions] per warp, 8 n-tiles of 8
    float s[FA_TILE / 8][4];
#pragma unroll
    for (int j = 0; j < FA_TILE / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int jp = 0; jp < FA_TILE / 16; ++jp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(kt + swz(16 * jp + (lane & 7) + ((lane >> 4) << 3), 2 * kc + ((lane >> 3) & 1)),
                b0, b1, b2, b3);
        mma_bf16(s[2 * jp], qf[kc][0], qf[kc][1], qf[kc][2], qf[kc][3], b0, b1);
        mma_bf16(s[2 * jp + 1], qf[kc][0], qf[kc][1], qf[kc][2], qf[kc][3], b2, b3);
      }
    }
    // mask per row on diagonal tiles; the running max m is kept in the raw
    // scores' units, and the scale enters the exponent in f32:
    // p = 2^(s * scale_log2 - m * scale_log2), one fma
    const int p0 = it * FA_TILE;
    const bool diag = p0 + FA_TILE - 1 > min_lim;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < FA_TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (diag && p0 + 8 * j + 2 * qd + (e & 1) > lim[e >> 1]) s[j][e] = NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], mc[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = ex2((m_run[i] - m_new) * scale_log2);
      m_run[i] = m_new;
      mc[i] = m_new * scale_log2;
    }
#pragma unroll
    for (int j = 0; j < FA_TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = s[j][e];
        const float p = v > 0.5f * NEG_INF ? ex2(fmaf(v, scale_log2, -mc[e >> 1])) : 0.f;
        s[j][e] = p;
        psum[e >> 1] += p;
      }
    // the lane's share of l (summed over the quad at the end)
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + psum[i];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // O += P V, 4 chunks of 16 positions: P as the A operand in two bf16
    // parts, hi = bf16(P) and lo = bf16(P - hi), so the product carries P to
    // ~16 bits as the plain version's f32 P does
#pragma unroll
    for (int kc = 0; kc < FA_TILE / 16; ++kc) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[2 * kc + (i >> 1)][2 * (i & 1)];
        const float y = s[2 * kc + (i >> 1)][2 * (i & 1) + 1];
        hi[i] = pack_bf16(x, y);
        lo[i] = pack_bf16(x - __uint_as_float(hi[i] << 16),
                          y - __uint_as_float(hi[i] & 0xFFFF0000u));
      }
#pragma unroll
      for (int jp = 0; jp < HD / 16; ++jp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(vt + swz(16 * kc + (lane & 15), 2 * jp + (lane >> 4)), b0, b1, b2, b3);
        mma_bf16(o[2 * jp], hi[0], hi[1], hi[2], hi[3], b0, b1);
        mma_bf16(o[2 * jp + 1], hi[0], hi[1], hi[2], hi[3], b2, b3);
        mma_bf16(o[2 * jp], lo[0], lo[1], lo[2], lo[3], b0, b1);
        mma_bf16(o[2 * jp + 1], lo[0], lo[1], lo[2], lo[3], b2, b3);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's copies into the Q buffer have landed

  // 3. normalise (zeros where no position was seen) and write the warp's
  // rows, staged through its own rows of the Q buffer for 16-byte stores
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-20f);
  }
  uint8_t* stage = fa_smem + FA_Q;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + g + 8 * i;
      *reinterpret_cast<uint32_t*>(stage + swz(r, j) + 4 * qd) =
          pack_bf16(o[j][2 * i] * inv[i], o[j][2 * i + 1] * inv[i]);
    }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 16 * (HD / 8) / 32; ++k) {
    const int i = lane + 32 * k;
    const int r = 16 * warp + (i >> 4), c = i & 15;
    const int t = t_begin + r / group;
    if (t < T)
      *reinterpret_cast<uint4*>(out + (((size_t)b * T + t) * n_q + h * group + r % group) * HD +
                                c * 8) = *reinterpret_cast<const uint4*>(stage + swz(r, c));
  }
}

}  // namespace

// q [B, n_q, 128], pools [n_kv, S, 128] (one layer plane), k_new/v_new
// [B, n_kv, 128], slots [B], block_tables [B, W], kv_lens [B] (length after
// this step's write), out [B, n_q, 128]. group = n_q / n_kv <= 16.
extern "C" int mrt_paged_decode(const void* q, void* k_pool, void* v_pool, const void* k_new,
                                const void* v_new, const void* slots, const void* block_tables,
                                const void* kv_lens, void* out, int B, int n_q, int n_kv, int hd,
                                int S, int W, int bs, float scale_log2, void* stream) {
  if (hd != HD || n_q % n_kv != 0 || n_q / n_kv > DEC_MAX_GROUP) return (int)cudaErrorInvalidValue;
  dim3 grid(n_kv, B);
  paged_decode_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(k_pool),
      static_cast<__nv_bfloat16*>(v_pool), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<const int*>(slots),
      static_cast<const int*>(block_tables), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), n_q, n_kv, S, W, bs, scale_log2);
  return (int)cudaGetLastError();
}

// q [B, T, n_q, 128], pools [n_kv, S, 128], k_new/v_new [B, T, n_kv, 128],
// slots [B, T], block_tables [B, W], kv_lens [B] (after the chunk's writes),
// n_valid [B], out [B, T, n_q, 128]. The chunk's valid tokens sit at
// positions [kv_len - n_valid, kv_len). 64 % (n_q / n_kv) == 0.
extern "C" int mrt_paged_prefill(const void* q, void* k_pool, void* v_pool, const void* k_new,
                                 const void* v_new, const void* slots, const void* block_tables,
                                 const void* kv_lens, const void* n_valid, void* out, int B, int T,
                                 int n_q, int n_kv, int hd, int S, int W, int bs,
                                 float scale_log2, void* stream) {
  if (hd != HD || n_q % n_kv != 0 || FA_ROWS % (n_q / n_kv) != 0) return (int)cudaErrorInvalidValue;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      paged_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FA_SMEM);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int qtok = FA_ROWS / (n_q / n_kv);
  dim3 grid((T + qtok - 1) / qtok, n_kv, B);
  paged_prefill_kernel<<<grid, THREADS, FA_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(k_pool),
      static_cast<__nv_bfloat16*>(v_pool), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<const int*>(slots),
      static_cast<const int*>(block_tables), static_cast<const int*>(kv_lens),
      static_cast<const int*>(n_valid), static_cast<__nv_bfloat16*>(out), T, n_q, n_kv, S, W, bs,
      scale_log2);
  return (int)cudaGetLastError();
}
