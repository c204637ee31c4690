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
// ~295 at which the tensor cores would be the limit. At the serve contexts
// (~100 positions, a few tiles) and with few sequences a block's own latency
// chain (lookup, copy, the products of each tile, the merge) bounds it more
// than the bytes, so the plan spreads each sequence over many blocks.
//
// Design (split-KV flash decode, one launch):
//   - Grid (splits, B, head tiles x column groups) of 4-warp blocks. A head
//     tile is 16 query heads, the M = 16 rows of mma.sync m16n8k16 (a last
//     partial tile computes zero rows it does not write); a column group is
//     up to 512 of the rank columns (one for DeepSeek's rank 512). The
//     wrapper's static plan (ops/mla_attention.py: mla_plan, from the batch,
//     the table width and the SM count, never from kv_lens) sets the splits
//     and their clusters. Split s takes the sequence's 32-position tiles s,
//     s + splits, s + 2 splits, ...: a short sequence spreads over as many
//     blocks as it has tiles, a long one over all of them, and a block with
//     no tile does no loads.
//   - The rows come by bulk copies (cp.async.bulk, one 1152-byte row a
//     lane, 8 rows a warp, counted on the ring slot's mbarrier, which thread
//     0 arms with the tile's bytes before any copy) into a STAGES-deep ring,
//     the next tile in flight while this one is computed. Each row's
//     block-table lookup is done once, one tile ahead, so no copy waits on
//     it; the step's own slot is read from row_new where the copy is issued.
//   - Scores: the warps split the depth (D / 16 k-steps), each multiplying
//     its slice of Q (ldmatrix from shared memory) by the tile (ldmatrix, the
//     B operand) into [16 heads x 32 positions] f32 partial scores; the
//     partial tiles meet in shared memory and every warp sums them in warp
//     order, so all warps hold the same scores, max and sum with no other
//     exchange. The online softmax runs in f32, in base 2; P is rounded once
//     to bf16 (the sum l is taken over the rounded P) and goes from the
//     score registers straight into the A fragments of the PV product.
//   - O += P · rows[:, :rank] keeps the f32 accumulator [16 x 512] in
//     registers, 128 columns a warp, with the V fragments from
//     ldmatrix.trans. The fragments of both products are loaded a step ahead
//     of the products that use them (the helpers are volatile asm, issued in
//     source order). Two barriers per tile: the ring's and the scores'.
//   - A sequence with at most one tile is written out directly by split 0.
//     Otherwise the splits merge in two levels, in a fixed order, so two
//     calls give the same bits: each split with a tile leaves its f32
//     partial (acc, m, l) in its own shared memory, the cluster (up to 16
//     consecutive splits) synchronizes, and every block of the cluster
//     merges a slice of the output from its peers' partials (distributed
//     shared memory) in split order. With one cluster that is the output;
//     with several, each cluster's slices go to device memory, and the last
//     block of each slice to arrive (an int counter per slice, reset by that
//     block) merges the clusters' slices in cluster order. No float atomics.
//
// The write and the reads race when several blocks serve one sequence: the
// block of split 0 (head tile and column group 0) does the write, and every
// block reads a position whose physical slot equals this step's write slot
// (>= 0) from row_new instead of the pool. That is what the JAX kernel
// computes, which writes before it reads; with slot < 0 nothing is
// substituted, as there. (Rows of OTHER sequences written in the same launch
// are read from the pool as they are: the engine never shares a block that is
// being written. Several dropped writes may land in the trash row at once,
// from different blocks; that row is never read.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"
#include "wgmma.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int HT = 16;                 // query heads per tile: the m16 rows of the MMA
constexpr int TILE = 32;               // positions per tile of the ring
constexpr int STAGES = 2;              // tiles in the ring
constexpr int CG = 512;                // rank columns per block (a column group)
constexpr int WN = CG / NWARPS / 8;    // 8-column MMA tiles of the accumulator per warp
constexpr int NT = TILE / 8;           // 8-position MMA tiles of the scores
constexpr int RW = TILE / NWARPS;      // tile rows each warp copies
constexpr int QW = HT / NWARPS;        // query rows each warp copies
constexpr int MAX_SPLITS = 16;         // blocks of a cluster (16: a non-portable size)
constexpr int PST = CG + 8;            // f32 row stride of a partial in shared memory
constexpr float NEG_INF = -1e30f;
constexpr size_t MAX_SMEM = 232448;    // a block's dynamic shared memory on sm_90
static_assert(RW <= 32 && QW >= 1 && NT % 2 == 0 && WN % 2 == 0, "tile shapes");

// 2^x (the MUFU instruction; denormal results flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the cluster's barrier (all threads of all its blocks; release / acquire
// orders the shared-memory writes before it against the reads after it)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of the same shared-memory location in block `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_peer(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float4 ld_peer4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// add `bytes` to the transfers the current phase of `bar` waits for
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// a load issued where it stands (volatile asm keeps its place among the
// kernel's other asm, so its latency overlaps the work up to its first use)
__device__ __forceinline__ int ld_early(const int* p) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}
// arrive on `bar` and add `bytes` to the transfers its current phase waits for
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// a bulk copy of `bytes` (a multiple of 16) from global `src` to shared `dst`,
// counted on `bar` when it lands
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Dynamic shared memory (byte offsets) for rows padded to d16 = D rounded up
// to 16 (the MMA depth): a row stride of d16 + 8 bf16 (16 bytes of padding,
// so the 8 rows an ldmatrix reads at one column lie in 8 bank groups); the
// query tile, the ring, then the warps' partial scores [warp][n-tile][lane].
// After the walk the ring holds the block's partial: acc [16][PST] f32, then
// m [16] and l [16] (PART bytes).
constexpr uint32_t PART = (HT * PST + 2 * HT) * 4;
constexpr int PART_F = HT * CG + 2 * HT;  // floats of a cluster's partial in device memory
struct Layout {
  uint32_t row_b, q, ring, stage, xs, total;
};

__host__ __device__ inline Layout layout(int d16) {
  Layout L{};
  L.row_b = (uint32_t)(d16 + 8) * 2;
  L.q = 0;
  L.stage = TILE * L.row_b;
  L.ring = (uint32_t)align128((size_t)HT * L.row_b);
  const uint32_t ring_b = STAGES * L.stage > PART ? STAGES * L.stage : PART;
  L.xs = (uint32_t)align128(L.ring + (size_t)ring_b);
  L.total = L.xs + NWARPS * NT * 32 * 16;
  return L;
}

__global__ void __launch_bounds__(THREADS, 256 / THREADS)
mla_decode_kernel(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* pool,
                  const __nv_bfloat16* __restrict__ row_new, const int* __restrict__ slots,
                  const int* __restrict__ block_tables, const int* __restrict__ kv_lens,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ gpart,
                  int* __restrict__ counters, int nh, int D, int d16, int rank, int S, int W,
                  int bs, int csize, float scale_log2) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_last;
  __shared__ __align__(8) uint64_t full[STAGES];  // the ring's slots: landed
  const Layout L = layout(d16);
  const uint32_t sa = smem_u32(smem);
  const uint32_t qs = sa + L.q, ring = sa + L.ring;
  float4* xs = reinterpret_cast<float4*>(smem + L.xs);

  // clusters of csize consecutive splits: the block's cluster and its rank there
  const int split = blockIdx.x, splits = gridDim.x, b = blockIdx.y, z = blockIdx.z;
  const int ci = split / csize, crank = split - ci * csize;
  const int n_cg = (rank + CG - 1) / CG;
  const int ht = z / n_cg, cg = z - ht * n_cg;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int kv_len = kv_lens[b];
  const int slot = slots[b];
  const __nv_bfloat16* rn = row_new + (size_t)b * D;
  const int nch = D / 8;     // 16-byte chunks of a row
  const int nch16 = d16 / 8;

  // 1. the fused write (one block per sequence), before any read
  if (split == 0 && z == 0) {
    uint4* dst = reinterpret_cast<uint4*>(pool + (size_t)(slot >= 0 ? slot : S - 1) * D);
    for (int c = tid; c < nch; c += THREADS) dst[c] = reinterpret_cast<const uint4*>(rn)[c];
  }
  const int tiles = (kv_len + TILE - 1) / TILE;         // the sequence's tiles
  const int live = min(splits, tiles);                  // splits with a tile
  const int live_cl = (live + csize - 1) / csize;       // clusters with a tile
  const int mine = split < tiles ? (tiles - split + splits - 1) / splits : 0;
  if (live <= 1 ? split > 0 : ci >= live_cl) return;  // nothing to do, nothing to merge
  const int h0 = ht * HT, nh_t = min(HT, nh - h0);
  const int c0 = cg * CG, ncol = min(CG, rank - c0);  // this block's rank columns
  const int wt0 = warp * WN;                           // the warp's first 8-column tile
  const int wnt = max(0, min(WN, ncol / 8 - wt0));     // ... and how many it has (even)
  const int ksteps = d16 / 16;
  const int kb = warp * ksteps / NWARPS, ke = (warp + 1) * ksteps / NWARPS;  // depth slice

  float o[WN][4];  // the warp's columns of O [16 x 512], f32
#pragma unroll
  for (int j = 0; j < WN; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // rows g, g + 8

  if (mine > 0) {
    // 2. the rows come by bulk copies, one row a lane: the head tile's
    // queries (counted on the first slot's barrier) and 32-row tiles; the
    // block's i-th tile is the sequence's tile split + i * splits. Each
    // tile row's table entry is looked up one tile before its copy is
    // issued. Rows with no source (queries past nh_t, positions past
    // kv_len) are zero-filled, and so are the columns past D (never copied),
    // once.
    const uint32_t bar0 = smem_u32(full);
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < STAGES; ++i) mbar_init(bar0 + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (nch < nch16)
      for (int r = tid; r < HT + STAGES * TILE; r += THREADS)
        *reinterpret_cast<uint4*>(smem + (r < HT ? L.q + r * L.row_b
                                                 : L.ring + (r - HT) * L.row_b) + nch * 16) =
            make_uint4(0, 0, 0, 0);
    __syncthreads();
    const int* table = block_tables + (size_t)b * W;
    const uint32_t row_bytes = D * 2;
    // warp w copies tile rows RW w .. RW w + RW - 1 and query rows QW w ..,
    // lane k < RW (QW) one row; lane k holds its tile row's table entry
    auto zero_rows = [&](uint32_t base, unsigned rows) {  // the warp zero-fills these rows
      while (rows) {
        const int r = __ffs(rows) - 1;
        rows &= rows - 1;
        for (int c = lane; c < nch; c += 32)
          *reinterpret_cast<uint4*>(smem + (base - sa) + r * L.row_b + c * 16) =
              make_uint4(0, 0, 0, 0);
      }
    };
    auto tile_pos = [&](int i) { return (split + i * splits) * TILE; };
    auto entry = [&](int i) {
      const int p = tile_pos(i) + RW * warp + lane;
      return lane < RW && i < mine && p < kv_len ? ld_early(table + (unsigned)p / (unsigned)bs)
                                                 : -1;
    };
    auto expect = [&](int i) {  // thread 0: the bytes of the block's i-th tile
      mbar_arrive_expect(bar0 + 8 * (i % STAGES), min(TILE, kv_len - tile_pos(i)) * row_bytes);
    };
    auto issue = [&](int i, int ent) {
      const uint32_t bar = bar0 + 8 * (i % STAGES), base = ring + (i % STAGES) * L.stage;
      if (ent >= 0) {
        const int r = RW * warp + lane;
        const int phys = ent * bs + (int)((unsigned)(tile_pos(i) + r) % (unsigned)bs);
        bulk_copy(base + r * L.row_b, (slot >= 0 && phys == slot) ? rn : pool + (size_t)phys * D,
                  row_bytes, bar);
      }
      const unsigned none = __ballot_sync(0xffffffffu, lane < RW && ent < 0);
      zero_rows(base, none << (RW * warp));
    };

    // the queries and the first tiles: every byte expected before any copy
    if (tid == 0) {
      mbar_expect(bar0, nh_t * row_bytes);
#pragma unroll
      for (int i = 0; i < STAGES - 1; ++i)
        if (i < mine) expect(i);
    }
    __syncthreads();
    {
      const int r = QW * warp + lane;
      const bool qok = lane < QW && r < nh_t;
      if (qok) bulk_copy(qs + r * L.row_b, q + ((size_t)b * nh + h0 + r) * D, row_bytes, bar0);
      zero_rows(qs, (__ballot_sync(0xffffffffu, lane < QW && !qok) & ((1u << QW) - 1))
                        << (QW * warp));
    }
    int ent[STAGES];
#pragma unroll
    for (int i = 0; i < STAGES; ++i) ent[i] = entry(i);  // all in flight together
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i)
      if (i < mine) issue(i, ent[i]);
    int pend = ent[STAGES - 1];
    for (int it = 0; it < mine; ++it) {
      mbar_wait(bar0 + 8 * (it % STAGES), (it / STAGES) & 1);  // this tile (and Q) landed
      const int nxt = it + STAGES - 1;
      // the refilled slot's last tile landed an iteration ago: its next phase
      // may be armed before the barrier, and so before any of its copies
      if (tid == 0 && nxt < mine) expect(nxt);
      __syncthreads();  // the zero rows are written; the slot refilled below is free
      if (nxt < mine) {
        fence_proxy_async();  // the slot's reads before the copies that overwrite it
        issue(nxt, pend);
      }
      pend = entry(nxt + 1);  // used after the next barrier
      const uint32_t kt = ring + (it % STAGES) * L.stage;

      // 4. the warp's depth slice of the scores [16 heads x TILE positions],
      // even and odd k-steps into two sets of accumulators (two chains of
      // products in flight), added at the end; the next k-step's fragments
      // load while this one's products run (the helpers are volatile asm, so
      // the source order is the issue order)
      float s[NT][4], s2[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
      uint32_t fa[4], fb[NT / 2][4], ga[4], gb[NT / 2][4];
      auto load_s = [&](int kc, uint32_t(&a)[4], uint32_t(&bb)[NT / 2][4]) {
        ldsm_x4(qs + (lane & 15) * L.row_b + (2 * kc + (lane >> 4)) * 16, a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp)
          ldsm_x4(kt + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * L.row_b +
                      (2 * kc + ((lane >> 3) & 1)) * 16,
                  bb[jp][0], bb[jp][1], bb[jp][2], bb[jp][3]);
      };
      auto mma_s = [&](float(&acc)[NT][4], const uint32_t(&a)[4],
                       const uint32_t(&bb)[NT / 2][4]) {
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          mma_bf16(acc[2 * jp], a[0], a[1], a[2], a[3], bb[jp][0], bb[jp][1]);
          mma_bf16(acc[2 * jp + 1], a[0], a[1], a[2], a[3], bb[jp][2], bb[jp][3]);
        }
      };
      if (kb < ke) load_s(kb, fa, fb);
      for (int kc = kb; kc < ke; kc += 2) {
        if (kc + 1 < ke) load_s(kc + 1, ga, gb);
        mma_s(s, fa, fb);
        if (kc + 1 < ke) {
          if (kc + 2 < ke) load_s(kc + 2, fa, fb);
          mma_s(s2, ga, gb);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];
      // 5. the slices summed in warp order by every warp
#pragma unroll
      for (int j = 0; j < NT; ++j)
        xs[(warp * NT + j) * 32 + lane] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float4 v = xs[j * 32 + lane];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) {
          const float4 u = xs[(w * NT + j) * 32 + lane];
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
        s[j][0] = v.x;
        s[j][1] = v.y;
        s[j][2] = v.z;
        s[j][3] = v.w;
      }

      // 6. online softmax, the running max in the raw scores' units and the
      // scale in the exponent: p = 2^(s * scale_log2 - m * scale_log2); lane
      // (g, qd) holds positions 8 j + 2 qd (+1) of heads g and g + 8
      const int t0 = (split + it * splits) * TILE;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (t0 + 8 * j + 2 * qd + (e & 1) >= kv_len) s[j][e] = NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float alpha[2], mc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        alpha[i] = ex2((m_run[i] - m_new) * scale_log2);
        m_run[i] = m_new;
        mc[i] = m_new * scale_log2;
      }
      // P rounded once to bf16, as the A fragments of 16-position k-steps; l
      // over the rounded values (the lane's share, summed over the quad at the end)
      uint32_t pa[NT / 2][4];
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 2 * kc + (i >> 1), e = 2 * (i & 1), row = i & 1;
          const float x =
              s[j][e] > 0.5f * NEG_INF ? ex2(fmaf(s[j][e], scale_log2, -mc[row])) : 0.f;
          const float y =
              s[j][e + 1] > 0.5f * NEG_INF ? ex2(fmaf(s[j][e + 1], scale_log2, -mc[row])) : 0.f;
          pa[kc][i] = pack_bf16(x, y);
          psum[row] +=
              __uint_as_float(pa[kc][i] << 16) + __uint_as_float(pa[kc][i] & 0xFFFF0000u);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + psum[i];
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // 7. O += P · rows[:, :rank] over the warp's columns, V^T by
      // ldmatrix.trans: a k-step's fragments all load before its products
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
        uint32_t v[WN / 2][4];
#pragma unroll
        for (int jp = 0; jp < WN / 2; ++jp)
          if (2 * jp < wnt)
            ldsm_x4_trans(kt + (16 * kc + (lane & 15)) * L.row_b +
                              ((c0 >> 3) + wt0 + 2 * jp + (lane >> 4)) * 16,
                          v[jp][0], v[jp][1], v[jp][2], v[jp][3]);
#pragma unroll
        for (int jp = 0; jp < WN / 2; ++jp)
          if (2 * jp < wnt) {
            mma_bf16(o[2 * jp], pa[kc][0], pa[kc][1], pa[kc][2], pa[kc][3], v[jp][0], v[jp][1]);
            mma_bf16(o[2 * jp + 1], pa[kc][0], pa[kc][1], pa[kc][2], pa[kc][3], v[jp][2],
                     v[jp][3]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    }
  }

  // 8. at most one split with a tile: split 0 normalizes and writes (zeros
  // where no position was seen)
  const size_t out0 = ((size_t)b * nh + h0) * rank + c0;  // row 0 of the tile, first column
  if (live <= 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
      if (r >= nh_t) continue;
      const float inv = 1.f / fmaxf(l_run[i], 1e-20f);
#pragma unroll
      for (int j = 0; j < WN; ++j)
        if (j < wnt)
          *reinterpret_cast<uint32_t*>(out + out0 + (size_t)r * rank + 8 * (wt0 + j) + 2 * qd) =
              pack_bf16(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    }
    return;
  }

  // 9. several splits: each leaves its partial in its ring, then every block
  // merges a slice of the [16 x ncol] output from the live splits' partials,
  // in split order
  __syncthreads();  // the ring's last reads are done
  float* part = reinterpret_cast<float*>(smem + L.ring);
  if (split < live) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
#pragma unroll
      for (int j = 0; j < WN; ++j)
        if (j < wnt)
          *reinterpret_cast<float2*>(part + r * PST + 8 * (wt0 + j) + 2 * qd) =
              make_float2(o[j][2 * i], o[j][2 * i + 1]);
      if (warp == 0 && qd == 0) {
        part[HT * PST + r] = m_run[i];
        part[HT * PST + HT + r] = l_run[i];
      }
    }
  }
  cluster_sync();
  // the peers of this cluster with a tile
  const int peers = min(csize, live - ci * csize);
  uint32_t peer[MAX_SPLITS];
#pragma unroll
  for (int i = 0; i < MAX_SPLITS; ++i) peer[i] = i < peers ? peer_addr(ring, i) : 0u;
  const int n4 = ncol / 4;  // float4 columns of a row
  const int total = HT * n4;
  const int lo = crank * total / csize, hi = (crank + 1) * total / csize;  // this block's slice
  const size_t bz = (size_t)b * gridDim.z + z;
  float* gp = gpart + (bz * (splits / csize) + ci) * PART_F;  // the cluster's merged partial
  for (int idx = lo + tid; idx < hi; idx += THREADS) {
    const int r = idx / n4, c4 = idx - r * n4;
    float mb = NEG_INF;
#pragma unroll
    for (int i = 0; i < MAX_SPLITS; ++i)
      if (i < peers) mb = fmaxf(mb, ld_peer(peer[i] + (HT * PST + r) * 4));
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < MAX_SPLITS; ++i) {
      if (i < peers) {
        const float f = ex2((ld_peer(peer[i] + (HT * PST + r) * 4) - mb) * scale_log2);
        l = fmaf(f, ld_peer(peer[i] + (HT * PST + HT + r) * 4), l);
        const float4 v = ld_peer4(peer[i] + (r * PST + 4 * c4) * 4);
        acc.x = fmaf(f, v.x, acc.x);
        acc.y = fmaf(f, v.y, acc.y);
        acc.z = fmaf(f, v.z, acc.z);
        acc.w = fmaf(f, v.w, acc.w);
      }
    }
    if (live_cl == 1) {  // one cluster: the output
      if (r < nh_t) {
        const float inv = 1.f / fmaxf(l, 1e-20f);
        *reinterpret_cast<uint2*>(out + out0 + (size_t)r * rank + 4 * c4) = make_uint2(
            pack_bf16(acc.x * inv, acc.y * inv), pack_bf16(acc.z * inv, acc.w * inv));
      }
    } else {  // several: the cluster's partial (its rows' m and l from every thread of the row)
      *reinterpret_cast<float4*>(gp + r * CG + 4 * c4) = acc;
      gp[HT * CG + 2 * r] = mb;
      gp[HT * CG + 2 * r + 1] = l;
    }
  }
  cluster_sync();  // no block leaves while a peer may still read its partial
  if (live_cl == 1) return;

  // 10. several clusters: the last block of each slice (the same rank in
  // every cluster) to arrive merges that slice over the clusters, in order
  int* cnt = counters + bz * csize + crank;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(cnt, 1) == live_cl - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* g0 = gpart + bz * (splits / csize) * PART_F;
  for (int idx = lo + tid; idx < hi; idx += THREADS) {
    const int r = idx / n4, c4 = idx - r * n4;
    float mb = NEG_INF;
    for (int c = 0; c < live_cl; ++c) mb = fmaxf(mb, __ldcg(g0 + c * PART_F + HT * CG + 2 * r));
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < live_cl; ++c) {
      const float* gc = g0 + c * PART_F;
      const float f = ex2((__ldcg(gc + HT * CG + 2 * r) - mb) * scale_log2);
      l = fmaf(f, __ldcg(gc + HT * CG + 2 * r + 1), l);
      const float4 v = __ldcg(reinterpret_cast<const float4*>(gc + r * CG + 4 * c4));
      acc.x = fmaf(f, v.x, acc.x);
      acc.y = fmaf(f, v.y, acc.y);
      acc.z = fmaf(f, v.z, acc.z);
      acc.w = fmaf(f, v.w, acc.w);
    }
    if (r < nh_t) {
      const float inv = 1.f / fmaxf(l, 1e-20f);
      *reinterpret_cast<uint2*>(out + out0 + (size_t)r * rank + 4 * c4) =
          make_uint2(pack_bf16(acc.x * inv, acc.y * inv), pack_bf16(acc.z * inv, acc.w * inv));
    }
  }
  if (tid == 0) *cnt = 0;  // ready for the next call
}

}  // namespace

// q [B, nh, D], pool [S, D] (one layer plane, updated in place), row_new
// [B, D], slots [B] (< 0: the trash row S - 1), block_tables [B, W], kv_lens
// [B] (length after this step's write), out [B, nh, rank]. `splits` blocks
// per (sequence, head tile, column group), in clusters of `cluster` (1 to
// 16, dividing splits); with more than one cluster, partials f32 [B * Z *
// (splits / cluster) * 8224] and counters int32 [B * Z * cluster] (all
// zero, left zero), Z = ceil(nh / 16) * ceil(rank / 512). D % 8 == 0,
// rank % 16 == 0, rank <= D.
extern "C" int mrt_mla_decode(const void* q, void* pool, const void* row_new, const void* slots,
                              const void* block_tables, const void* kv_lens, void* out,
                              void* partials, void* counters, int B, int nh, int D, int rank,
                              int S, int W, int bs, int splits, int cluster, float scale_log2,
                              void* stream) {
  if (B < 0 || nh < 1 || D % 8 != 0 || rank % 16 != 0 || rank < 16 || rank > D || bs < 1 ||
      W < 1 || cluster < 1 || cluster > MAX_SPLITS || splits < cluster || splits % cluster ||
      (splits > cluster && (partials == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int d16 = (D + 15) / 16 * 16;
  const Layout L = layout(d16);
  if (L.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static size_t attr_set = 0;
  if (L.total > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mla_decode_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    attr_set = L.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B, ((nh + HT - 1) / HT) * ((rank + CG - 1) / CG));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, mla_decode_kernel, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(pool), static_cast<const __nv_bfloat16*>(row_new),
      static_cast<const int*>(slots), static_cast<const int*>(block_tables),
      static_cast<const int*>(kv_lens), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partials), static_cast<int*>(counters), nh, D, d16, rank, S, W, bs,
      cluster, scale_log2);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
