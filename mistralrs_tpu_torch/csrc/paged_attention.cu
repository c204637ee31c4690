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
// into the q scale, exactly the JAX kernels' math (ops/paged_attention.py:
// 31-35): exp2(log2e * x) == exp(x).
//
// What bounds them on the H100: device-memory bytes. Decode reads each
// sequence's K/V once (2 * kv_len * n_kv * hd * 2 B) for a handful of flops
// per byte; prefill reads the past K/V once per query tile. Design: one
// block of 4 warps per (KV head, sequence[, query tile]); all query heads of
// the GQA group share the block, so each K/V row is read once per group. K/V
// move through shared memory 64 positions at a time (16-byte loads; the K
// tile's rows are padded to 130 elements so lane-per-position dot products
// are free of bank conflicts). The scores use plain FMAs, not tensor cores:
// simple and right first; the times against the bound are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;      // head_dim (the wrapper requires it)
constexpr int TILE = 64;     // KV positions per shared-memory tile
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int KS_LD = HD + 2;   // bf16 elements; 65 words per row
constexpr float NEG_INF = -1e30f;
constexpr int DEC_MAX_GROUP = 16;               // decode: query heads per KV head
constexpr int DEC_HEADS_PER_WARP = DEC_MAX_GROUP / NWARPS;
constexpr int PF_ROWS = 64;                     // prefill: query rows per block
constexpr int PF_ROWS_PER_WARP = PF_ROWS / NWARPS;

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
// prefill: grid (query tiles, n_kv, B); a tile is PF_ROWS = qtok * group
// query rows (row R → token qt * qtok + R / group, head R % group)
// ---------------------------------------------------------------------------

constexpr int PF_QS_BYTES = PF_ROWS * HD * 4;
constexpr int PF_KS_BYTES = TILE * KS_LD * 2;
constexpr int PF_VS_BYTES = TILE * HD * 2;
constexpr int PF_PS_LD = TILE + 1;
constexpr int PF_SMEM = PF_QS_BYTES + PF_KS_BYTES + PF_VS_BYTES + PF_ROWS * PF_PS_LD * 4;

__global__ void __launch_bounds__(THREADS)
paged_prefill_kernel(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* k_pool,
                     __nv_bfloat16* v_pool, const __nv_bfloat16* __restrict__ k_new,
                     const __nv_bfloat16* __restrict__ v_new, const int* __restrict__ slots,
                     const int* __restrict__ block_tables, const int* __restrict__ kv_lens,
                     const int* __restrict__ n_valid_arr, __nv_bfloat16* __restrict__ out,
                     int T, int n_q, int n_kv, int S, int W, int bs, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + PF_QS_BYTES);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + PF_QS_BYTES + PF_KS_BYTES);
  float* ps = reinterpret_cast<float*>(smem + PF_QS_BYTES + PF_KS_BYTES + PF_VS_BYTES);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = n_q / n_kv;
  const int qtok = PF_ROWS / group;
  const int t_begin = qt * qtok;
  const int kv_len = kv_lens[b];
  const int nv = n_valid_arr[b];
  const int ctx = kv_len - nv;  // past tokens already in the pool

  // 1. write this tile's tokens' K/V rows (t < n_valid, slot >= 0). The
  // rows read below never touch these slots: positions >= ctx come from
  // k_new/v_new, so no block of this launch reads a slot another one writes.
  for (int i = tid; i < qtok * HD; i += THREADS) {
    const int tl = i / HD, d = i - tl * HD;
    const int t = t_begin + tl;
    if (t >= T || t >= nv) continue;
    const int slot = slots[(size_t)b * T + t];
    if (slot < 0) continue;
    const size_t src = (((size_t)b * T + t) * n_kv + h) * HD + d;
    const size_t dst = ((size_t)h * S + slot) * HD + d;
    k_pool[dst] = k_new[src];
    v_pool[dst] = v_new[src];
  }
  // 2. queries, pre-scaled into the log2 domain (rows past T are zeros)
  for (int i = tid; i < PF_ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD;
    const int t = t_begin + r / group, g = r % group;
    float v = 0.f;
    if (t < T) v = __bfloat162float(q[(((size_t)b * T + t) * n_q + h * group + g) * HD + d]);
    qs[i] = v * scale_log2;
  }
  // each row's last visible position: its own (ctx + t) for valid tokens;
  // rows past n_valid see the whole cache (their output is never read)
  // (a tile with no valid token skips the attention: its output is zeros)
  const int last_valid_t = min(t_begin + qtok, nv) - 1;
  const int block_lim = t_begin >= nv ? -1
                        : (t_begin + qtok <= nv) ? ctx + last_valid_t : kv_len - 1;
  __syncthreads();

  float m[PF_ROWS_PER_WARP], l[PF_ROWS_PER_WARP], acc[PF_ROWS_PER_WARP][4];
  int lim[PF_ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < PF_ROWS_PER_WARP; ++r) {
    const int R = warp * PF_ROWS_PER_WARP + r;
    const int t = t_begin + R / group;
    lim[r] = t < nv ? ctx + t : kv_len - 1;
    m[r] = NEG_INF;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
  const int* table = block_tables + (size_t)b * W;
  auto row_of = [&](int p, const __nv_bfloat16*& kp, const __nv_bfloat16*& vp) {
    if (p >= kv_len || p > block_lim) {
      kp = vp = nullptr;
    } else if (p < ctx) {
      const size_t off = ((size_t)h * S + (size_t)table[p / bs] * bs + p % bs) * HD;
      kp = k_pool + off;
      vp = v_pool + off;
    } else {
      const size_t off = (((size_t)b * T + (p - ctx)) * n_kv + h) * HD;
      kp = k_new + off;
      vp = v_new + off;
    }
  };
  for (int t0 = 0; t0 <= block_lim && t0 < kv_len; t0 += TILE) {
    load_tile(ks, vs, t0, row_of);
    __syncthreads();
    const __nv_bfloat162* k0 = reinterpret_cast<const __nv_bfloat162*>(ks + lane * KS_LD);
    const __nv_bfloat162* k1 = reinterpret_cast<const __nv_bfloat162*>(ks + (lane + 32) * KS_LD);
    const float* qw = qs + warp * PF_ROWS_PER_WARP * HD;
    float s0[PF_ROWS_PER_WARP], s1[PF_ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < PF_ROWS_PER_WARP; ++r) s0[r] = s1[r] = 0.f;
    for (int d = 0; d < HD / 2; ++d) {
      const float2 ka = __bfloat1622float2(k0[d]);
      const float2 kb = __bfloat1622float2(k1[d]);
#pragma unroll
      for (int r = 0; r < PF_ROWS_PER_WARP; ++r) {
        const float2 qf = reinterpret_cast<const float2*>(qw + r * HD)[d];
        s0[r] = fmaf(qf.x, ka.x, fmaf(qf.y, ka.y, s0[r]));
        s1[r] = fmaf(qf.x, kb.x, fmaf(qf.y, kb.y, s1[r]));
      }
    }
    const int p0i = t0 + lane, p1i = t0 + lane + 32;
#pragma unroll
    for (int r = 0; r < PF_ROWS_PER_WARP; ++r) {
      const float a = p0i <= lim[r] ? s0[r] : NEG_INF;
      const float c = p1i <= lim[r] ? s1[r] : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(a, c)));
      const float alpha = exp2f(m[r] - m_new);
      const float pa = a > 0.5f * NEG_INF ? exp2f(a - m_new) : 0.f;
      const float pc = c > 0.5f * NEG_INF ? exp2f(c - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(pa + pc);
      m[r] = m_new;
      const int R = warp * PF_ROWS_PER_WARP + r;
      ps[R * PF_PS_LD + lane] = pa;
      ps[R * PF_PS_LD + lane + 32] = pc;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();
    for (int j = 0; j < TILE; ++j) {
      const float4 v = v_quad(vs, j, lane);
#pragma unroll
      for (int r = 0; r < PF_ROWS_PER_WARP; ++r) {
        const float pj = ps[(warp * PF_ROWS_PER_WARP + r) * PF_PS_LD + j];
        acc[r][0] = fmaf(pj, v.x, acc[r][0]);
        acc[r][1] = fmaf(pj, v.y, acc[r][1]);
        acc[r][2] = fmaf(pj, v.z, acc[r][2]);
        acc[r][3] = fmaf(pj, v.w, acc[r][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < PF_ROWS_PER_WARP; ++r) {
    const int R = warp * PF_ROWS_PER_WARP + r;
    const int t = t_begin + R / group, g = R % group;
    if (t >= T) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
    __nv_bfloat16* o = out + (((size_t)b * T + t) * n_q + h * group + g) * HD + lane * 4;
    o[0] = __float2bfloat16_rn(acc[r][0] * inv);
    o[1] = __float2bfloat16_rn(acc[r][1] * inv);
    o[2] = __float2bfloat16_rn(acc[r][2] * inv);
    o[3] = __float2bfloat16_rn(acc[r][3] * inv);
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
  if (hd != HD || n_q % n_kv != 0 || PF_ROWS % (n_q / n_kv) != 0) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(paged_prefill_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, PF_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int qtok = PF_ROWS / (n_q / n_kv);
  dim3 grid((T + qtok - 1) / qtok, n_kv, B);
  paged_prefill_kernel<<<grid, THREADS, PF_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(k_pool),
      static_cast<__nv_bfloat16*>(v_pool), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<const int*>(slots),
      static_cast<const int*>(block_tables), static_cast<const int*>(kv_lens),
      static_cast<const int*>(n_valid), static_cast<__nv_bfloat16*>(out), T, n_q, n_kv, S, W, bs,
      scale_log2);
  return (int)cudaGetLastError();
}
