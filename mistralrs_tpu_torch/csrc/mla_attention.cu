// MLA paged decode over a bf16 latent pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel of mistralrs_tpu/ops/mla_attention.py:
//   mla_decode_fused (:161, pallas_call :218, body _mla_kernel :33).
//
// Absorbed multi-head latent attention is MQA over ONE row per token,
// row = [compressed latent (rank) ‖ roped k_pe (rope)], D = rank + rope,
// shared by every query head:
//   write row_new[b] to pool[slot_b] (slot < 0: the trash row S - 1);
//   out[b, h] = sum_p softmax_p(scale * q[b, h] · row_p) * row_p[:rank]
// over positions p < kv_len[b], row_p = pool[table[b, p / bs] * bs + p % bs];
// f32 softmax and sums, bf16 output, zeros for kv_len 0 (the JAX kernel's
// acc / max(l, 1e-20)). exp2 with log2(e) folded into the scale, as in the
// JAX kernel.
//
// What bounds it on the H100: device-memory bytes. Each position's row
// (D * 2 = 1152 B for DeepSeek-V2) is read once for all query heads and feeds
// ~2 * nh * (D + rank) flops, ~30 flops per byte at 16 heads, far below the
// ~295 at which the tensor cores would be the limit.
//
// Design (flash-decoding): one block of 4 warps per (KV split, sequence,
// head tile of 16). A split is `span` positions (a multiple of 64); the
// wrapper picks enough splits to give the card ~2 blocks per SM, and a split
// past kv_len exits at once. A block streams 64-row tiles of pool rows
// through shared memory (16-byte loads), computes the [16 x 64] scores with
// bf16 wmma fragments (sixteen heads are exactly one m16 tile), runs the
// online softmax in f32 on them, and adds P · rows[:, :rank] (wmma again, P
// rounded to bf16, the running sum l taken over the same rounded P) into an
// f32 accumulator [16 x rank] kept in shared memory. Each split writes its
// unnormalized accumulator, running max and sum; a second kernel combines
// the splits of each (sequence, head).
//
// The write and the reads race when several blocks serve one sequence: the
// block of split 0 (head tile 0) does the write, and every block reads a
// position whose physical slot equals this step's write slot (>= 0) from
// row_new instead of the pool. That is what the JAX kernel computes, which
// writes before it reads; with slot < 0 nothing is substituted, as there.
// (Rows of OTHER sequences written in the same launch are read from the
// pool as they are: the engine never shares a block that is being written.
// Several dropped writes may land in the trash row at once, from different
// blocks; that row is never read.)
//
// Simple and right first: no cp.async or TMA pipeline, no wgmma; its times
// against the bound are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int HT = 16;                   // query heads per tile: one m16 fragment
constexpr int TILE = 64;                 // positions per shared-memory tile
constexpr int ROWS_PER_WARP = HT / NWARPS;
constexpr int LDS = TILE + 4;            // f32 score tile stride
constexpr int LDP = TILE + 8;            // bf16 probability tile stride
constexpr float NEG_INF = -1e30f;
constexpr size_t MAX_SMEM = 232448;      // a block's dynamic shared memory on sm_90

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

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Dynamic shared memory of the split kernel (byte offsets), for rows padded
// to d16 = D rounded up to 16 (the wmma depth) and a row stride of d16 + 8
// (16-byte aligned, and 32-byte aligned at every 16th row and column as
// wmma loads need).
struct Layout {
  int ldk;
  size_t qs, ks, ss, ps, os, scr, alpha, total;
};

__host__ __device__ inline Layout layout(int d16, int rank) {
  Layout L{};
  L.ldk = d16 + 8;
  size_t off = 0;
  L.qs = off;    off = align128(off + (size_t)HT * L.ldk * 2);      // q tile, bf16
  L.ks = off;    off = align128(off + (size_t)TILE * L.ldk * 2);    // pool rows, bf16
  L.ss = off;    off = align128(off + (size_t)HT * LDS * 4);        // scores, f32
  L.ps = off;    off = align128(off + (size_t)HT * LDP * 2);        // P, bf16
  L.os = off;    off = align128(off + (size_t)HT * rank * 4);       // accumulator, f32
  L.scr = off;   off = align128(off + (size_t)NWARPS * 256 * 4);    // per-warp PV tile
  L.alpha = off; off = align128(off + (size_t)HT * 4);              // per-row rescale
  L.total = off;
  return L;
}

__global__ void __launch_bounds__(THREADS)
mla_decode_split_kernel(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* pool,
                        const __nv_bfloat16* __restrict__ row_new, const int* __restrict__ slots,
                        const int* __restrict__ block_tables, const int* __restrict__ kv_lens,
                        float* __restrict__ o_part, float* __restrict__ ml_part, int nh, int D,
                        int d16, int rank, int S, int W, int bs, int span, int n_split,
                        float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(d16, rank);
  const int ldk = L.ldk;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.qs);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L.ks);
  float* ss = reinterpret_cast<float*>(smem + L.ss);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + L.ps);
  float* os = reinterpret_cast<float*>(smem + L.os);
  float* scr = reinterpret_cast<float*>(smem + L.scr) + (threadIdx.x >> 5) * 256;
  float* alpha_s = reinterpret_cast<float*>(smem + L.alpha);

  const int split = blockIdx.x, b = blockIdx.y, ht = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_len = kv_lens[b];
  const int slot = slots[b];
  const __nv_bfloat16* rn = row_new + (size_t)b * D;
  const int nch = D / 8;     // 16-byte chunks of a row
  const int nch16 = d16 / 8;

  // 1. the fused write (one block per sequence)
  if (split == 0 && ht == 0) {
    uint4* dst = reinterpret_cast<uint4*>(pool + (size_t)(slot >= 0 ? slot : S - 1) * D);
    for (int c = tid; c < nch; c += THREADS) dst[c] = reinterpret_cast<const uint4*>(rn)[c];
  }
  const int p_begin = split * span;
  if (p_begin >= kv_len) return;  // an empty split: the combine skips it
  const int p_end = min(p_begin + span, kv_len);
  const int h0 = ht * HT;
  const int nh_t = min(HT, nh - h0);

  // 2. the head tile's queries (rows past nh_t and columns past D are zero)
  // and a zero accumulator
  for (int i = tid; i < HT * nch16; i += THREADS) {
    const int r = i / nch16, c = i - r * nch16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < nh_t && c < nch)
      v = reinterpret_cast<const uint4*>(q + ((size_t)b * nh + h0 + r) * D)[c];
    reinterpret_cast<uint4*>(qs + r * ldk)[c] = v;
  }
  for (int i = tid; i < HT * rank; i += THREADS) os[i] = 0.f;
  float m[ROWS_PER_WARP], l[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  const int* table = block_tables + (size_t)b * W;

  for (int t0 = p_begin; t0 < p_end; t0 += TILE) {
    __syncthreads();  // the last tile's PV reads of ks are done
    // 3. the tile's rows (positions past p_end are zero rows)
    for (int i = tid; i < TILE * nch16; i += THREADS) {
      const int r = i / nch16, c = i - r * nch16;
      const int p = t0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (p < p_end && c < nch) {
        const int phys = table[p / bs] * bs + p % bs;
        const __nv_bfloat16* src = (slot >= 0 && phys == slot) ? rn : pool + (size_t)phys * D;
        v = reinterpret_cast<const uint4*>(src)[c];
      }
      reinterpret_cast<uint4*>(ks + r * ldk)[c] = v;
    }
    __syncthreads();
    // 4. scores [16 x 64]: warp w computes positions w*16 .. w*16+15
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
      wmma::fill_fragment(sc, 0.f);
      for (int kk = 0; kk < d16; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
        wmma::load_matrix_sync(a, qs + kk, ldk);
        wmma::load_matrix_sync(kb, ks + warp * 16 * ldk + kk, ldk);
        wmma::mma_sync(sc, a, kb, sc);
      }
      wmma::store_matrix_sync(ss + warp * 16, sc, LDS, wmma::mem_row_major);
    }
    __syncthreads();
    // 5. online softmax in the log2 domain: warp w owns heads w*4 .. w*4+3
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      float s0 = ss[r * LDS + lane] * scale_log2;
      float s1 = ss[r * LDS + lane + 32] * scale_log2;
      if (t0 + lane >= p_end) s0 = NEG_INF;
      if (t0 + lane + 32 >= p_end) s1 = NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      const float alpha = exp2f(m[i] - m_new);
      const __nv_bfloat16 p0 = __float2bfloat16_rn(s0 > 0.5f * NEG_INF ? exp2f(s0 - m_new) : 0.f);
      const __nv_bfloat16 p1 = __float2bfloat16_rn(s1 > 0.5f * NEG_INF ? exp2f(s1 - m_new) : 0.f);
      ps[r * LDP + lane] = p0;
      ps[r * LDP + lane + 32] = p1;
      l[i] = l[i] * alpha + warp_sum(__bfloat162float(p0) + __bfloat162float(p1));
      m[i] = m_new;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();
    // 6. acc = alpha * acc + P · rows[:, :rank]: warp w takes the 16-column
    // tiles w, w + 4, ...
    for (int nt = warp; nt < rank / 16; nt += NWARPS) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pv;
      wmma::fill_fragment(pv, 0.f);
#pragma unroll
      for (int kk = 0; kk < TILE; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
        wmma::load_matrix_sync(a, ps + kk, LDP);
        wmma::load_matrix_sync(vb, ks + kk * ldk + nt * 16, ldk);
        wmma::mma_sync(pv, a, vb, pv);
      }
      wmma::store_matrix_sync(scr, pv, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4;
        float* o = os + r * rank + nt * 16 + (e & 15);
        *o = *o * alpha_s[r] + scr[e];
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // 7. this split's unnormalized accumulator, running max and sum
  float* ob = o_part + (((size_t)b * n_split + split) * nh + h0) * rank;
  for (int i = tid; i < nh_t * rank; i += THREADS) ob[i] = os[i];
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      if (r < nh_t) {
        float* ml = ml_part + (((size_t)b * n_split + split) * nh + h0 + r) * 2;
        ml[0] = m[i];
        ml[1] = l[i];
      }
    }
  }
}

// grid (nh, B): merge the non-empty splits of one (sequence, head)
__global__ void __launch_bounds__(THREADS)
mla_decode_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ ml_part,
                          const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ out,
                          int nh, int rank, int span, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_act = min(n_split, (kv_lens[b] + span - 1) / span);  // kv_len 0: none
  const float* ml = ml_part + ((size_t)b * n_split * nh + h) * 2;   // split s at + s*nh*2
  float mx = NEG_INF;
  for (int s = 0; s < n_act; ++s) mx = fmaxf(mx, ml[(size_t)s * nh * 2]);
  float lsum = 0.f;
  for (int s = 0; s < n_act; ++s)
    lsum += ml[(size_t)s * nh * 2 + 1] * exp2f(ml[(size_t)s * nh * 2] - mx);
  const float inv = 1.f / fmaxf(lsum, 1e-20f);
  const float* ob = o_part + ((size_t)b * n_split * nh + h) * rank;  // split s at + s*nh*rank
  for (int c = threadIdx.x; c < rank; c += THREADS) {
    float acc = 0.f;
    for (int s = 0; s < n_act; ++s)
      acc += ob[(size_t)s * nh * rank + c] * exp2f(ml[(size_t)s * nh * 2] - mx);
    out[((size_t)b * nh + h) * rank + c] = __float2bfloat16_rn(acc * inv);
  }
}

}  // namespace

// q [B, nh, D], pool [S, D] (one layer plane, updated in place), row_new
// [B, D], slots [B] (< 0: the trash row S - 1), block_tables [B, W], kv_lens
// [B] (length after this step's write), out [B, nh, rank]; scratch o_part
// [B, n_split, nh, rank] and ml_part [B, n_split, nh, 2] f32. span % 64 == 0,
// D % 8 == 0, rank % 16 == 0, rank <= D.
extern "C" int mrt_mla_decode(const void* q, void* pool, const void* row_new, const void* slots,
                              const void* block_tables, const void* kv_lens, void* out,
                              void* o_part, void* ml_part, int B, int nh, int D, int rank, int S,
                              int W, int bs, int span, int n_split, float scale_log2,
                              void* stream) {
  if (B < 1 || nh < 1 || D % 8 != 0 || rank % 16 != 0 || rank < 16 || rank > D ||
      span % TILE != 0 || span < TILE || n_split < 1 || bs < 1)
    return (int)cudaErrorInvalidValue;
  const int d16 = (D + 15) / 16 * 16;
  const Layout L = layout(d16, rank);
  if (L.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static size_t attr_set = 0;
  if (L.total > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(mla_decode_split_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
    if (e != cudaSuccess) return (int)e;
    attr_set = L.total;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(n_split, B, (nh + HT - 1) / HT);
  mla_decode_split_kernel<<<grid, THREADS, L.total, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(pool),
      static_cast<const __nv_bfloat16*>(row_new), static_cast<const int*>(slots),
      static_cast<const int*>(block_tables), static_cast<const int*>(kv_lens),
      static_cast<float*>(o_part), static_cast<float*>(ml_part), nh, D, d16, rank, S, W, bs,
      span, n_split, scale_log2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mla_decode_combine_kernel<<<dim3(nh, B), THREADS, 0, st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
      static_cast<const int*>(kv_lens), static_cast<__nv_bfloat16*>(out), nh, rank, span,
      n_split);
  return (int)cudaGetLastError();
}
