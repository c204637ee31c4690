// Paged attention over a block-table KV cache, for Hopper (sm_90a): the
// kernels' bodies, included by one translation unit per head dim
// (paged_attention_hd{64,80,96,128,256}.cu, each instantiating its head
// dim's forms, mrt_pa::decode_forms<D> and mrt_pa::prefill_forms<D>) and by
// paged_attention.cu, whose C entry points dispatch across them with only
// the declarations below (PA_ENTRY_ONLY). One nvcc per head dim keeps the
// build's longest compile to one head dim's forms.
//
// Replaces the TPU kernels of mistralrs_tpu/ops/paged_attention.py:
//   paged_decode_attention_fused (:496, body _decode_kernel :38) and
//   paged_prefill_attention_fused (:1162, body _prefill_kernel :525),
// for bf16 pools at head_dim 64, 80, 96, 128 or 256 (template argument D)
// with a sliding window, an attention logit softcap (Gemma-2, gpt-oss; the
// JAX kernels' window and softcap) and attention sinks (gpt-oss; the JAX
// kernels' sinks), and, in their quantized forms (template argument Q: 1
// int8, 2 fp8-e4m3; the JAX kernels' quantized=True), for 1-byte pools with
// bf16 scales, at the same head dims and with the same options.
//
// Head dims 80 and 96 (Phi-2, Phi-3-mini) compute at their true width: D /
// 16 = 5 or 6 k-steps of the QK^T product and as many 16-dim tiles of PV.
// The JAX package pads their pools to 128 lanes for its kernels; these pools
// stay [n_kv, S, D]. In shared memory a row keeps head_dim 128's pitch of
// 256 bytes (pitch_dims): the XOR swizzle over groups of 8 16-byte chunks
// maps the 10 or 12 chunks of a bf16 row into the row's 16, so ldmatrix's
// 8 rows at one logical chunk still lie in 8 bank groups, at the cost of the
// last 6 or 4 chunks of every row unused (the stages take head_dim 128's
// shared memory). The copies give each of a row's 10 or 12 chunks (5 or 6
// for a code row) a thread: a pass of the block copies the whole rows that
// its 128 threads cover (12 or 10 rows; 25 or 21 code rows) and the
// threads left over idle. A quantized row is held by 20 or 24 lanes of a
// warp, 4 dims each, the rest idle but in the absmax's reduction.
//
// Pool layout (one layer plane): [n_kv, S, hd] bf16, slot = block * bs + row.
// Both kernels write this step's K/V rows into the pools in place, then run
// an online-softmax (flash) attention in f32 with exp2 and log2(e) folded
// into the scale, the JAX kernels' math (ops/paged_attention.py: 31-35):
// exp2(log2e * x) == exp(x).
//
// Decode (one query token per sequence): split-KV flash decode. Bound:
// device-memory bytes; it reads each sequence's K/V once (2 * kv_len * n_kv
// * hd * 2 B) for a handful of flops per byte, so the card has to keep
// loads in flight on every SM whatever the batch and the lengths.
//   - The wrapper's static plan (ops/paged_attention.py: decode_plan, from
//     the batch, the table width and the SM count, never from kv_lens) cuts
//     the table's positions into splits of `span` positions (a multiple of
//     64) so that the grid (splits, n_kv, B) holds >= 2 blocks per SM. A
//     block of 4 warps attends over [s * span, min((s + 1) * span, kv_len))
//     for all query heads of its GQA group; a split at or past kv_len exits
//     at once.
//   - K/V tiles of 64 positions are gathered through the block table into
//     a cp.async ring (the prefill kernel's swizzled 256-byte rows), so the
//     next tile's copy runs under this tile's math; the walk over the table
//     uses additions, not a division per chunk.
//   - Scores and PV run on mma.sync m16n8k16 with the K (or V^T) tile as the
//     16-row operand and the group's queries as the 8-column operand (groups
//     over 8 take two such tiles): S^T = K Q^T, O^T += V^T P^T. Each warp
//     owns 16 positions of every tile and keeps its own running max and sum
//     per head (no barrier between warps inside the walk); P^T reaches the
//     B-fragment layout by movmatrix, in two bf16 parts, hi = bf16(P) and
//     lo = bf16(P - hi), as in the prefill kernel (P rounded once moved
//     Mixtral's expert choices to the 99 % floor of chip_smoke.py's phase
//     3b). The score step per tile is one function, where a window, a
//     softcap or sinks would enter.
//   - The block merges its 4 warps in warp order. A sequence whose kv_len
//     fits one split is then written out; otherwise each split writes f32
//     partials (m, l, acc[D]) per query head, and the last split block of
//     the (sequence, KV head) to arrive (an int counter, reset by that
//     block) merges them in split order: no float atomics, and the result
//     does not depend on which block came last.
//   - This step's K/V row is written to slots[b] (dropped when < 0) by the
//     block whose split holds position kv_len - 1, before it reads that
//     position; no other block reads it. kv_len 0 gives zeros
//     (acc / max(l, 1e-20)). GQA groups 1 to 16, head_dim 64, 80, 96, 128
//     or 256.
//   - A sliding window (a query at kv_len - 1 sees kv_len - window ...
//     kv_len - 1) moves the walk's start to the tile that holds kv_len -
//     window, and the wrapper's plan (decode_plan with the window) splits
//     only the positions from there, at most window + 63: at 8 x 8192 with
//     a 4096 window the kernel reads half the table (the JAX kernel masks
//     and walks every chunk). The positions of that first tile below the
//     window are masked in the score step.
//   - A softcap c maps each score s (q k, unscaled) to c tanh(s scale / c),
//     the true logit capped, before the mask and the running max; log2(e)
//     then multiplies in the exponent (the wrapper's scale_log2 is log2(e),
//     not scale log2(e)). It is a template argument (CAP): the forms
//     without one compile no tanh.
//   - At head_dim 256 a block keeps its 4 warps and 64-position tiles, so
//     its two stages take 128 KB of shared memory and one block fits an
//     SM (three at 128); each warp's O^T accumulators double to 64
//     registers a head tile. At head_dim 64 (gpt-oss) the stages take 32
//     KB, a row is one 128-byte line, and the merges leave threads 64-127
//     idle.
//   - Sinks (gpt-oss: one f32 logit per query head, JAX _decode_kernel
//     :318-327) enter the softmax once per (sequence, head) as one more
//     term of the merge: a partial with m = sink and l = 1 and no value.
//     A sequence that fits one split adds it where its warps merge; one
//     that splits adds it in the last block's merge of the splits, and in
//     no split's partials, so a split that the window leaves empty adds
//     nothing. The sink is a true logit (the softcap does not reach it), in
//     the kernel's score units sink * log2(e) / scale_log2. A null pointer
//     means no sinks.
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
// two blocks per SM (the registers allow no more). GQA groups 1 to 64: a
// tile holds qtok = 64 / group tokens (integer division), so a group that
// does not divide 64 (Qwen2.5-7B's 7: 9 tokens, 63 rows) leaves the last
// 64 - qtok * group rows dead; they load zeros, see the tile's last visible
// position and are never stored. A sliding window skips the KV tiles wholly below the smallest
// query's horizon (row 0's position - window + 1; JAX _prefill_kernel
// :869-875) and masks per row on the tiles below the largest one; the
// softcap is applied as in decode (template argument CAP). Sinks (JAX
// :786-795) enter each row's softmax once, at the end of the walk: the
// row's (m, l) takes the sink as one more term before the output is
// normalised. At head_dim 64 a block keeps its 4 warps, each with its 16
// rows' Q in registers (16 registers) and O at 32.
// At head_dim 256 a warp's Q fragments (64 registers) would not fit beside
// its accumulators (the head_dim-128 form takes 221-235 registers, 32 of Q, 64
// of O): the block has 8 warps, warps w and w + 4 own the same 16 query rows
// and each half of O's head dims (64 registers of O each), both compute
// the whole S = Q K^T (the QK product twice, a simple first design), and
// they re-read Q's fragments from shared memory every tile, where Q keeps
// a region of its own behind the stages (2 x 64 KB of K/V tiles + 32 KB of
// Q: one block of 8 warps per SM).
//
// Quantized forms (1-byte code pools [n_kv, S, D], scales [n_kv, S] bf16
// beside them, head-major; blocks of a multiple of 8 positions). Bound:
// bytes, as the bf16 forms, on D + 2 bytes a cached row in place of 2 D.
//   - Writes: this step's rows are quantized as they are written, per (token,
//     KV head) by one warp (quant_row: the JAX package's qenc over the whole
//     head, each lane D / 32 dims (4 on 20 or 24 lanes at head_dim 80 and
//     96), the absmax a warp reduction; in f32 with a
//     true division, rint for int8, a saturating round-to-nearest-even cast
//     for e4m3), codes into the pool and bf16(s) into the scale plane. In
//     decode the writing block reads the row back after the barrier, as the
//     bf16 form does; prefill writes in its first launch (below).
//   - Reads: code tiles of 64 positions (64 D bytes for K, as many for V)
//     and the tile's 64 + 64 scales come through the same cp.async ring,
//     then the block's warps widen the codes to bf16 in shared memory (int8
//     and e4m3 are exact in bf16), in the swizzled layout the mma.sync
//     fragments of the bf16 forms read at that D; the scales go to f32
//     beside them. Widening in registers is later work.
//   - The fold, in the score step (decode_scores; the prefill's S loop): a
//     position's k scale multiplies its f32 score first, then the softcap
//     caps it (c tanh(s scale / c), JAX _decode_kernel :292-299), then the
//     window masks it, before the running max; p enters the running sum l
//     unscaled, and is then multiplied by the position's v scale before the
//     PV product. Sinks enter the merges as in the bf16 forms, untouched by
//     the scales and the cap. A window starts the walk, the code copies and
//     the scale copies at the tile that holds its first position.
//   - Prefill: a first launch (quant_chunk_kernel) quantizes each of the
//     chunk's rows once, writes its codes and scale, and writes its round
//     trip bf16(code * s), with the unrounded f32 scale, to a scratch like
//     k_new; the attention launch reads the past (positions < ctx) from the
//     code pools with its scales, and the chunk's own rows from the scratch,
//     folding no scale (the JAX kernel's self tiles). Round-tripping them
//     in every block that reads them cost more than the rest of the tile's
//     work (probes/quant_attention_parts.py).
//   - Shared memory: a stage keeps its widened bf16 K/V tiles beside its
//     code tiles and scales, in both kernels' layouts, because the prefill's
//     chunk rows land (cp.async, bf16) straight in the next stage's widened
//     tile while this one is read. At head_dim 256 the prefill's two stages
//     (2 x 98,560 B), its Q region (32,768 B) and the f32 scales (512 B) take
//     230,400 of the 232,448 bytes a block may opt into: it fits, so all
//     three head dims keep one layout (one widened buffer would take ~164 KB
//     but needs a staging copy of the chunk's rows). Decode widens into one
//     tile ahead of its code ring (132,096 B at 256: one block per SM).

#ifndef MRT_PAGED_ATTENTION_CUH
#define MRT_PAGED_ATTENTION_CUH

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mrt_pa {

constexpr int FA_ROWS = 64;      // query rows per prefill block (4 warps x 16)
constexpr int FA_TILE = 64;      // KV positions per tile
constexpr int DC_MAX_GROUP = 16;  // query heads per KV head in decode

// One launch's arguments (the C entry points' own; paged_attention.cu).
// Pointers: q, the pools and their scale planes (null for bf16 pools), this
// step's K/V rows, slots, block tables, kv_lens, n_valid (prefill), out,
// the decode's split partials and counters, sinks (null: none), the
// quantized prefill's round-trip scratch k_rt/v_rt.
struct Args {
  const void* q;
  void* k_pool;
  void* v_pool;
  void* k_scale;
  void* v_scale;
  const void* k_new;
  const void* v_new;
  const void* slots;
  const void* block_tables;
  const void* kv_lens;
  const void* n_valid;
  void* out;
  void* partials;
  void* counters;
  const void* sinks;
  void* k_rt;
  void* v_rt;
  int B, T, n_q, n_kv, S, W, bs, span, splits, window;
  float softcap, cap_in, scale_log2;
  cudaStream_t stream;
};

// The forms of head dim D: qkind 0 bf16 pools, 1 int8, 2 fp8-e4m3; a
// softcap (a.softcap > 0) selects the capped instances
template <int D>
cudaError_t decode_forms(int qkind, const Args& a);
template <int D>
cudaError_t prefill_forms(int qkind, const Args& a);

}  // namespace mrt_pa

#ifndef PA_ENTRY_ONLY

#include "ptx.cuh"

namespace {

using mrt_pa::DC_MAX_GROUP;
using mrt_pa::FA_ROWS;
using mrt_pa::FA_TILE;

constexpr int HD = 128;      // the middle head_dim: its forms' launch bounds and Q layout
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E_F = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// prefill: FlashAttention-2 style on the tensor cores. grid (query tiles, n_kv,
// B); a tile is FA_ROWS query rows, each warp 16 of them: rows R < qtok *
// group (qtok = FA_ROWS / group) are token qt * qtok + R / group, head
// R % group; the rest (when group does not divide FA_ROWS) are dead.
// ---------------------------------------------------------------------------

constexpr int FA_STAGES = 2;                 // K/V tiles in the cp.async ring
// Q lands in the last stage's K tile, is read into registers, and that stage
// is then filled like the others; the output is staged there at the end
// (PfLayout below)

// 2^x (the MUFU instruction; denormal results flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// head dims of a row's pitch in shared memory: D rounded up to 64, 128 or
// 256, so that a bf16 row is 8, 16 or 32 chunks of 16 bytes and the XOR
// swizzle below closes over it (80 and 96 keep 128's 256-byte rows)
template <int D>
__host__ __device__ constexpr int pitch_dims() {
  static_assert(D % 16 == 0 && D <= 256, "head_dim a multiple of 16, at most 256");
  return D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// byte offset of 16-byte chunk c (8 head dims) of row r in a [rows][2
// pitch B] tile of D head dims: chunks XOR-swizzled by r % 8, so the 8 rows
// an ldmatrix reads at one logical chunk lie in 8 different bank groups
template <int D>
__device__ __forceinline__ uint32_t swzh(int r, int c) {
  return (uint32_t)(r * (2 * pitch_dims<D>()) + ((c ^ (r & 7)) << 4));
}

// the lanes of a warp that hold a D-dim row in the quantized forms, K dims
// each: all 32 at head_dim 64, 128 and 256 (K = 2, 4, 8); 20 or 24 at 80
// and 96 (K = 4), the rest idle
template <int D>
__host__ __device__ constexpr int lane_dims() {
  return D % 64 == 0 ? D / 32 : 4;
}
template <int D>
__host__ __device__ constexpr int row_lanes() {
  return D / lane_dims<D>();
}

// The copy passes of a tile's rows of CPR 16-byte chunks by NT threads:
// thread t takes chunk t % CPR of rows t / CPR + RPP j (RPP = NT / CPR), the
// threads past RPP CPR none. every_row: the passes hold every thread and
// end at the tile's last row (CPR a power of two), so no row test is needed
template <int CPR, int NT>
struct CopyPasses {
  static constexpr int RPP = NT / CPR;                    // rows a pass copies
  static constexpr int N = (FA_TILE + RPP - 1) / RPP;     // passes a tile
  static constexpr bool every_row = RPP * CPR == NT && FA_TILE % RPP == 0;
};

// the scores of a softcapped layer: softcap * tanh(s * cap_in), the true
// logit capped (cap_in = scale / softcap); the exponent then multiplies by
// log2(e) alone (the wrapper's scale_log2)
__device__ __forceinline__ float capped(float s, float softcap, float cap_in) {
  return softcap * tanhf(s * cap_in);
}

// ---------------------------------------------------------------------------
// quantized forms: codes, scales and the widening pass. A D-dim row is held
// by one warp, lane l owning dims K l ... K l + K - 1 (K = lane_dims: 2, 4
// or 8; at head_dim 80 and 96 lanes 20 or 24 on hold none)
// ---------------------------------------------------------------------------

constexpr int QC_SC_B = FA_TILE * 2;  // a tile's 64 bf16 scales

// K bf16 at p (one 4-, 8- or 16-byte load) to f32
template <int K>
__device__ __forceinline__ void load_bf16_lane(const __nv_bfloat16* p, float (&x)[K]) {
  static_assert(K == 2 || K == 4 || K == 8, "head_dim 64, 128 or 256");
  uint32_t w[K / 2];
  if constexpr (K == 2) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (K == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < K / 2; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// K / 2 words (K bf16) to p in one store
template <int K>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[K / 2]) {
  if constexpr (K == 2) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else if constexpr (K == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// K code bytes (byte i in word i / 4) from or to p in one access
template <int K>
__device__ __forceinline__ void load_codes(const uint8_t* p, uint32_t (&c)[(K + 3) / 4]) {
  if constexpr (K == 2) {
    c[0] = *reinterpret_cast<const uint16_t*>(p);
  } else if constexpr (K == 4) {
    c[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    c[0] = v.x;
    c[1] = v.y;
  }
}
template <int K>
__device__ __forceinline__ void store_codes(uint8_t* p, const uint32_t (&c)[(K + 3) / 4]) {
  if constexpr (K == 2) {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)c[0];
  } else if constexpr (K == 4) {
    *reinterpret_cast<uint32_t*>(p) = c[0];
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(c[0], c[1]);
  }
}

// The K codes of this lane's share of a row and the row's f32 scale s: the
// JAX package's qenc (ops/paged_attention.py:185-194, kv/paged.py:210-222),
// the absmax over the whole head. Every lane of the warp must call it (the
// absmax is a warp reduction).
template <bool FP8, int K>
__device__ __forceinline__ void quant_row(const float (&x)[K], float& s,
                                          uint32_t (&c)[(K + 3) / 4]) {
  float a = fabsf(x[0]);
#pragma unroll
  for (int i = 1; i < K; ++i) a = fmaxf(a, fabsf(x[i]));
#pragma unroll
  for (int o = 16; o; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  s = a / (FP8 ? 448.f : 127.f);  // a true f32 division (no fast-math flags)
  const float d = fmaxf(s, 1e-10f);
#pragma unroll
  for (int i = 0; i < (K + 3) / 4; ++i) c[i] = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float y = x[i] / d;
    uint32_t b;
    if constexpr (FP8) {
      b = __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
    } else {
      b = (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(rintf(y), -127.f), 127.f);  // half to even
    }
    c[i / 4] |= (b & 0xFFu) << (8 * (i % 4));
  }
}

// a code byte's value (exact in f32, f16 and bf16)
template <bool FP8>
__device__ __forceinline__ float code_f32(uint32_t c) {
  if constexpr (FP8) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)(c & 0xFFu),
                                                       __NV_E4M3)));
  } else {
    return (float)(int8_t)(c & 0xFFu);
  }
}

// code byte i of a lane's codes, times f
template <bool FP8, int K>
__device__ __forceinline__ float code_at(const uint32_t (&c)[(K + 3) / 4], int i, float f) {
  return code_f32<FP8>(c[i / 4] >> (8 * (i % 4))) * f;
}

// byte offset of this lane's K bf16 in row r of a swizzled [64][2 pitch B] tile
template <int D>
__device__ __forceinline__ uint32_t wide_at(int r, int lane) {
  constexpr int K = lane_dims<D>();
  return swzh<D>(r, (K * lane) >> 3) + 2 * ((K * lane) & 7);
}

// This lane's K dims of the D-dim bf16 row at `src` to f32: zeros for a lane
// that holds none (they leave the row's absmax as it is)
template <int D>
__device__ __forceinline__ void load_row_lane(const __nv_bfloat16* src, int lane,
                                              float (&x)[lane_dims<D>()]) {
  constexpr int K = lane_dims<D>();
  if (row_lanes<D>() == 32 || lane < row_lanes<D>()) {
    load_bf16_lane<K>(src + K * lane, x);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) x[i] = 0.f;
  }
}

// Quantize row `src` (D bf16 in global memory) into pool row `dst` (D codes)
// and its scale: called by a whole warp.
template <bool FP8, int D>
__device__ __forceinline__ void quant_write_row(const __nv_bfloat16* src, uint8_t* dst,
                                                __nv_bfloat16* scale_dst, int lane) {
  constexpr int K = lane_dims<D>();
  float x[K], s;
  uint32_t c[(K + 3) / 4];
  load_row_lane<D>(src, lane, x);
  quant_row<FP8, K>(x, s, c);
  if (row_lanes<D>() == 32 || lane < row_lanes<D>()) store_codes<K>(dst + K * lane, c);
  if (lane == 0) *scale_dst = __float2bfloat16_rn(s);
}

// Row r of a code tile (unswizzled [64][D B] at byte address `codes`)
// widened to bf16 into row r of a swizzled [64][2 pitch B] tile at `wide`:
// each lane that holds dims its K codes to K bf16.
template <bool FP8, int D>
__device__ __forceinline__ void widen_row(const uint8_t* codes, uint8_t* wide, int r, int lane) {
  constexpr int K = lane_dims<D>();
  if (row_lanes<D>() < 32 && lane >= row_lanes<D>()) return;
  uint32_t c[(K + 3) / 4], w[K / 2];
  load_codes<K>(codes + r * D + K * lane, c);
#pragma unroll
  for (int i = 0; i < K / 2; ++i)
    w[i] = pack_bf16(code_at<FP8, K>(c, 2 * i, 1.f), code_at<FP8, K>(c, 2 * i + 1, 1.f));
  store_words<K>(wide + wide_at<D>(r, lane), w);
}

// The quantized prefill's first launch: each valid row of the chunk (t <
// n_valid) is quantized once, by one warp: its codes and bf16 scale go to
// slots[b, t] (slot < 0: dropped), and its round trip bf16(code * s), with
// the f32 scale, to k_rt/v_rt [B, T, n_kv, D], where the attention
// launch reads the chunk's own rows. Grid (ceil(T * n_kv / 2), B): a block's
// warps take (token, KV head) rows 2 x + w / 2, K for even w, V for odd.
template <bool FP8, int D>
__global__ void __launch_bounds__(THREADS)
quant_chunk_kernel(const __nv_bfloat16* __restrict__ k_new,
                   const __nv_bfloat16* __restrict__ v_new, const int* __restrict__ slots,
                   const int* __restrict__ n_valid_arr, uint8_t* k_pool, uint8_t* v_pool,
                   __nv_bfloat16* k_scale, __nv_bfloat16* v_scale,
                   __nv_bfloat16* __restrict__ k_rt, __nv_bfloat16* __restrict__ v_rt, int T,
                   int n_kv, int S) {
  constexpr int K = lane_dims<D>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, b = blockIdx.y;
  const int row = blockIdx.x * (NWARPS / 2) + (warp >> 1);  // t * n_kv + h
  if (row >= T * n_kv) return;
  const int t = row / n_kv, h = row % n_kv;
  if (t >= n_valid_arr[b]) return;
  const bool is_v = warp & 1;
  const size_t row0 = ((size_t)b * T * n_kv + row) * D;
  const bool holds = row_lanes<D>() == 32 || lane < row_lanes<D>();  // dims of the row
  float x[K], s;
  uint32_t c[(K + 3) / 4], w[K / 2];
  load_row_lane<D>((is_v ? v_new : k_new) + row0, lane, x);
  quant_row<FP8, K>(x, s, c);
#pragma unroll
  for (int i = 0; i < K / 2; ++i)
    w[i] = pack_bf16(code_at<FP8, K>(c, 2 * i, s), code_at<FP8, K>(c, 2 * i + 1, s));
  if (holds) store_words<K>((is_v ? v_rt : k_rt) + row0 + K * lane, w);
  const int slot = slots[(size_t)b * T + t];
  if (slot < 0) return;
  const size_t at = (size_t)h * S + slot;
  if (holds) store_codes<K>((is_v ? v_pool : k_pool) + at * D + K * lane, c);
  if (lane == 0) (is_v ? v_scale : k_scale)[at] = __float2bfloat16_rn(s);
}

// Shared memory of the prefill kernel's forms: Q = 0 (bf16) holds two
// stages of bf16 K/V tiles; a quantized form's stage adds the code tiles and
// the scales behind them, and the f32 scales of the tile in use follow the
// stages. At head_dim 64 and 128 Q lands in the last stage and is read into
// registers; at 256 (two stages of 64 KB, or 96.25 KB with the codes) Q
// keeps a region of its own behind the stages and each warp re-reads its
// fragments from there every tile: its 64 registers would not fit beside
// the accumulators. Head dims 80 and 96 take head_dim 128's layout (rows of
// 256 bytes, pitch_dims), their code tiles rows of D bytes.
template <int Q, int D>
struct PfLayout {
  static constexpr int ROW_B = 2 * pitch_dims<D>();      // a bf16 row of Q, K or V
  static constexpr int KV_B = FA_TILE * ROW_B;           // one K or V tile
  static constexpr int QC = 2 * KV_B;                    // the codes' offset in a stage
  static constexpr int QC_KV_B = FA_TILE * D;            // one K or V code tile
  static constexpr int STAGE_B = 2 * KV_B + (Q ? 2 * QC_KV_B + 2 * QC_SC_B : 0);
  static constexpr bool QREG = D <= HD;                  // Q fragments in registers
  static_assert(!QREG || FA_ROWS * ROW_B <= KV_B, "Q must fit a K tile");
  // 4 warps of 16 query rows for every 128 head dims of O (at most 128 a
  // warp): at 256, warps w and w + 4 own the same rows and each half of the
  // head dims
  static constexpr int THREADS = D <= HD ? 128 : 128 * (D / 128);
  static constexpr int QOFF = QREG ? (FA_STAGES - 1) * STAGE_B : FA_STAGES * STAGE_B;
  static constexpr int SF = FA_STAGES * STAGE_B + (QREG ? 0 : FA_ROWS * ROW_B);
  static constexpr int SMEM = SF + (Q ? 2 * FA_TILE * 4 : 0);  // f32 scales [2][64]
  static_assert(SMEM <= 232448, "a block's shared memory");
};

template <int Q, int D, bool CAP>
__global__ void __launch_bounds__(PfLayout<Q, D>::THREADS, D <= 64 ? 3 : (D <= HD ? 2 : 1))
paged_prefill_kernel(const __nv_bfloat16* __restrict__ q, uint8_t* k_pool, uint8_t* v_pool,
                     __nv_bfloat16* k_scale, __nv_bfloat16* v_scale,
                     const __nv_bfloat16* __restrict__ k_new,
                     const __nv_bfloat16* __restrict__ v_new, const int* __restrict__ slots,
                     const int* __restrict__ block_tables, const int* __restrict__ kv_lens,
                     const int* __restrict__ n_valid_arr, __nv_bfloat16* __restrict__ out,
                     const float* __restrict__ sinks, int T, int n_q, int n_kv, int S, int W,
                     int bs, int window, float softcap, float cap_in, float scale_log2) {
  using L = PfLayout<Q, D>;
  constexpr bool FP8 = Q == 2;
  constexpr int NT = L::THREADS;
  constexpr int ROW_B = Q ? D : 2 * D;            // bytes of a pool row
  // (thread indices divide by CPR as unsigned: a signed division's fix-up
  // for negative values cost the issue-bound body 5 % at head_dim 128)
  constexpr int CPR = D / 8;                      // 16-byte chunks of a bf16 row
  using KvPasses = CopyPasses<CPR, NT>;
  constexpr int RPP = KvPasses::RPP;              // rows one pass of the block copies
  constexpr int DW = D < 128 ? D : 128;           // head dims of O a warp owns
  constexpr int CW = DW / 8;                      // 16-byte chunks of them a row
  extern __shared__ __align__(128) uint8_t fa_smem[];
  const uint32_t sa = smem_u32(fa_smem);
  // later query tiles see more positions: they start first
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the warp's 16 rows and its half of O's head dims (compile-time 0 at 128)
  const int rw = D <= HD ? warp : warp & 3, dh = D <= HD ? 0 : warp >> 2;
  const int g = lane >> 2, qd = lane & 3;
  const int group = n_q / n_kv;
  const int qtok = FA_ROWS / group;
  const int real = qtok * group;  // rows past it are dead: zeros in, nothing out
  const int t_begin = qt * qtok;
  const int kv_len = kv_lens[b];
  const int nv = n_valid_arr[b];
  const int ctx = kv_len - nv;  // past tokens already in the pool

  // 1. write this tile's tokens' K/V rows (t < n_valid, slot >= 0). The
  // rows read below never touch these slots: positions >= ctx come from
  // k_new/v_new, so no block of this launch reads a slot another one writes.
  // (A quantized form's rows were written by quant_chunk_kernel, launched
  // first; its k_new/v_new are their round trips.)
  if constexpr (Q == 0) {
    for (int i = tid; i < qtok * CPR; i += NT) {
      const int t = t_begin + (int)((unsigned)i / CPR), c = (int)((unsigned)i % CPR);
      if (t >= T || t >= nv) continue;
      const int slot = slots[(size_t)b * T + t];
      if (slot < 0) continue;
      const size_t src = (((size_t)b * T + t) * n_kv + h) * D + c * 8;
      const size_t dst = ((size_t)h * S + slot) * ROW_B + c * 16;
      *reinterpret_cast<uint4*>(k_pool + dst) = *reinterpret_cast<const uint4*>(k_new + src);
      *reinterpret_cast<uint4*>(v_pool + dst) = *reinterpret_cast<const uint4*>(v_new + src);
    }
  }
  // 2. the tile's queries into shared memory (rows past T, dead rows: zeros)
  for (int i = tid; i < FA_ROWS * CPR; i += NT) {
    const int r = (int)((unsigned)i / CPR), c = (int)((unsigned)i % CPR);
    const int t = t_begin + r / group;
    const bool ok = t < T && r < real;
    cp_async16(sa + L::QOFF + swzh<D>(r, c),
               q + (ok ? (((size_t)b * T + t) * n_q + h * group + r % group) * D + c * 8 : 0),
               ok);
  }
  cp_async_commit();

  // Each row's last visible position: its own (ctx + t) for valid tokens;
  // rows past n_valid see the whole cache (their output is never read), dead
  // rows the tile's last (block_lim; they hold no token).
  // block_lim is the tile's largest, min_lim its smallest (row 0's): KV
  // tiles past block_lim are skipped (a tile with no valid token reads
  // nothing and writes zeros), tiles wholly at or below min_lim need no
  // causal mask. A sliding window (JAX _prefill_kernel :869-875) hides the
  // positions below lim - window + 1 (lo) from a row: the walk starts at
  // the tile holding row 0's lo, and only tiles below the largest lo need
  // the window's mask.
  const int last_valid_t = min(t_begin + qtok, nv) - 1;
  const int block_lim = t_begin >= nv ? -1
                        : (t_begin + qtok <= nv) ? ctx + last_valid_t : kv_len - 1;
  const int min_lim = ctx + t_begin;
  const int win = window;
  const int max_lo = win > 0 ? block_lim - win + 1 : 0;
  int lim[2], lo[2];  // this lane's rows 16 rw + g and + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * rw + g + 8 * i, t = t_begin + r / group;
    lim[i] = r >= real ? block_lim : t < nv ? ctx + t : kv_len - 1;
    lo[i] = win > 0 ? lim[i] - win + 1 : -1;
  }
  const int c0 = win > 0 ? max(0, min_lim - win + 1) / FA_TILE : 0;  // first tile
  const int n_tiles = block_lim < 0 ? 0 : block_lim / FA_TILE + 1 - c0;

  // The next K/V tile (positions [p0, p0 + 64), tiles loaded in order from
  // tile c0) into slot buf, gathered through the block table (positions <
  // ctx) or from k_new/v_new (>= ctx); rows past block_lim are zero-filled.
  // Thread: chunk tc = tid % CPR of rows tr + RPP j (tr = tid / CPR); (blk, off) is its
  // first row's table entry and offset in the block, advanced by additions,
  // not divisions. A quantized form loads the past's code rows instead
  // (chunk tid % QCPR of rows tid / QCPR + QRPP j, walked the same way from
  // the first tile) and their scales (threads 0-15, 8 positions each), and
  // leaves the rows past block_lim to widen.
  const int* table = block_tables + (size_t)b * W;
  const size_t pool_h = (size_t)h * S;
  const int p_start = c0 * FA_TILE;
  const int tr = (int)((unsigned)tid / CPR), tc = (int)((unsigned)tid % CPR);
  int blk = (p_start + tr) / bs, off0 = (p_start + tr) % bs;
  constexpr int QCPR = D / 16;      // 16-byte chunks of a code row
  using QcPasses = CopyPasses<QCPR, NT>;
  constexpr int QRPP = QcPasses::RPP;  // code rows one pass of the block copies
  const int qr = (int)((unsigned)tid / QCPR), cq = (int)((unsigned)tid % QCPR);
  // at head_dim 80 and 96 the threads past whole rows copy nothing
  const bool kv_copier = tid < RPP * CPR, qc_copier = tid < QRPP * QCPR;
  int qblk = (p_start + qr) / bs, qoff = (p_start + qr) % bs;
  int sblk = (p_start + 8 * (tid & 7)) / bs, soff = (p_start + 8 * (tid & 7)) % bs;
  auto load_kv = [&](int buf, int p0) {
    const uint32_t st = sa + buf * L::STAGE_B;
    const int c = tc;
    int bj = blk, oj = off0;
#pragma unroll
    for (int j = 0; j < KvPasses::N; ++j) {
      const int r = tr + RPP * j, p = p0 + r;
      const bool row = KvPasses::every_row || (kv_copier && r < FA_TILE);
      if constexpr (Q == 0) {
        const bool ok = p <= block_lim;
        const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(k_pool);
        const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(v_pool);
        size_t off = 0;
        if (ok) {
          if (p < ctx) {
            off = (pool_h + (size_t)table[bj] * bs + oj) * D;
          } else {
            off = (((size_t)b * T + (p - ctx)) * n_kv + h) * D;
            kb = k_new;
            vb = v_new;
          }
        }
        if (row) {
          cp_async16(st + swzh<D>(r, c), kb + off + c * 8, ok);
          cp_async16(st + L::KV_B + swzh<D>(r, c), vb + off + c * 8, ok);
        }
        for (oj += RPP; oj >= bs; oj -= bs) ++bj;
      } else if (row && p >= ctx && p <= block_lim) {  // the chunk's own rows, in bf16
        const size_t off = (((size_t)b * T + (p - ctx)) * n_kv + h) * D + c * 8;
        cp_async16(st + swzh<D>(r, c), k_new + off, true);
        cp_async16(st + L::KV_B + swzh<D>(r, c), v_new + off, true);
      }
    }
    for (off0 += FA_TILE; off0 >= bs; off0 -= bs) ++blk;
    if constexpr (Q != 0) {
      const int past_end = min(ctx, block_lim + 1);  // the tile's past rows: p < past_end
      int qj = qblk, oq = qoff;
#pragma unroll
      for (int j = 0; j < QcPasses::N; ++j) {
        const int r = qr + QRPP * j, p = p0 + r;
        if ((QcPasses::every_row || (qc_copier && r < FA_TILE)) && p < past_end) {
          const size_t off = (pool_h + (size_t)table[qj] * bs + oq) * ROW_B + cq * 16;
          cp_async16(st + L::QC + r * D + cq * 16, k_pool + off, true);
          cp_async16(st + L::QC + L::QC_KV_B + r * D + cq * 16, v_pool + off, true);
        }
        for (oq += QRPP; oq >= bs; oq -= bs) ++qj;
      }
      for (qoff += FA_TILE; qoff >= bs; qoff -= bs) ++qblk;
      if (tid < 16) {  // scales of positions p0 + 8 (tid % 8) ... + 7, K (tid < 8) or V
        if (p0 + 8 * (tid & 7) < past_end) {
          const size_t at = pool_h + (size_t)table[sblk] * bs + soff;
          cp_async16(st + L::QC + 2 * L::QC_KV_B + (tid >> 3) * QC_SC_B + 16 * (tid & 7),
                     (tid < 8 ? k_scale : v_scale) + at, true);
        }
        for (soff += FA_TILE; soff >= bs; soff -= bs) ++sblk;
      }
    }
  };
  // The quantized forms' pass over the landed tile (positions p0 ...) in
  // slot buf: each of the NT / 32 warps takes RPW rows of K and of V. A past
  // row's codes are widened to bf16 and its scale goes to f32; a row of the
  // chunk (loaded as its round trip bf16(code * s)) folds 1; a row past
  // block_lim becomes zeros and folds 0.
  float* sf = reinterpret_cast<float*>(fa_smem + L::SF);  // k scales [64], v scales [64]
  auto widen = [&](int buf, int p0) {
    constexpr int RPW = FA_TILE / (NT / 32);  // rows a warp widens
    uint8_t* st = fa_smem + buf * L::STAGE_B;
    for (int i = 0; i < 2 * RPW; ++i) {
      const int r = RPW * warp + (i >> 1), kv = i & 1, p = p0 + r;
      uint8_t* wide = st + kv * L::KV_B;
      float f;
      if (p > block_lim) {
        constexpr int K = lane_dims<D>();
        const uint32_t zero[K / 2] = {};
        if (row_lanes<D>() == 32 || lane < row_lanes<D>())
          store_words<K>(wide + wide_at<D>(r, lane), zero);
        f = 0.f;
      } else if (p < ctx) {
        widen_row<FP8, D>(st + L::QC + kv * L::QC_KV_B, wide, r, lane);
        f = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
            st + L::QC + 2 * L::QC_KV_B + kv * QC_SC_B)[r]);
      } else {
        f = 1.f;
      }
      if (lane == 0) sf[kv * FA_TILE + r] = f;
    }
  };

  float o[DW / 8][4];  // [16 x 128] output rows of the warp (its head dims), f32
#pragma unroll
  for (int j = 0; j < DW / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  uint32_t qf[L::QREG ? D / 16 : 1][4];  // Q as A fragments, chunks of 16 head dims
  const uint32_t qrow = sa + L::QOFF;    // Q's tile (its own region at head_dim 256)

#pragma unroll
  for (int i = 0; i < FA_STAGES - 1; ++i) {
    if (i < n_tiles) load_kv(i, (c0 + i) * FA_TILE);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<FA_STAGES - 2>();  // Q and this tile have landed
    __syncthreads();  // ... for every thread; the slot refilled below is free
    if constexpr (L::QREG) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc)
          ldsm_x4(qrow + swzh<D>(16 * rw + (lane & 15), 2 * kc + (lane >> 4)), qf[kc][0],
                  qf[kc][1], qf[kc][2], qf[kc][3]);
        __syncthreads();  // Q's slot is refilled next
      }
    }
    const int nxt = it + FA_STAGES - 1;
    if (nxt < n_tiles) load_kv(nxt % FA_STAGES, (c0 + nxt) * FA_TILE);
    cp_async_commit();
    const int p0 = (c0 + it) * FA_TILE;
    if constexpr (Q != 0) {
      widen(it % FA_STAGES, p0);
      __syncthreads();  // the widened tile and its scales, for every warp
    }
    const uint32_t kt = sa + (it % FA_STAGES) * L::STAGE_B, vt = kt + L::KV_B;

    // S = Q K^T: [16 rows x 64 positions] per warp, 8 n-tiles of 8 (at
    // head_dim 256 both warps of a row group compute the same S)
    float s[FA_TILE / 8][4];
#pragma unroll
    for (int j = 0; j < FA_TILE / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a0, a1, a2, a3;
      if constexpr (L::QREG) {
        a0 = qf[kc][0];
        a1 = qf[kc][1];
        a2 = qf[kc][2];
        a3 = qf[kc][3];
      } else {
        ldsm_x4(qrow + swzh<D>(16 * rw + (lane & 15), 2 * kc + (lane >> 4)), a0, a1, a2, a3);
      }
#pragma unroll
      for (int jp = 0; jp < FA_TILE / 16; ++jp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(kt + swzh<D>(16 * jp + (lane & 7) + ((lane >> 4) << 3), 2 * kc + ((lane >> 3) & 1)),
                b0, b1, b2, b3);
        mma_bf16(s[2 * jp], a0, a1, a2, a3, b0, b1);
        mma_bf16(s[2 * jp + 1], a0, a1, a2, a3, b2, b3);
      }
    }
    // the k scales fold into the scores (position 8 j + 2 qd + (e & 1)),
    // before the mask and the max
    if constexpr (Q != 0) {
#pragma unroll
      for (int j = 0; j < FA_TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sf[8 * j + 2 * qd + (e & 1)];
    }
    if constexpr (CAP) {  // the capped logit, before the mask and the max
#pragma unroll
      for (int j = 0; j < FA_TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = capped(s[j][e], softcap, cap_in);
    }
    // mask per row on diagonal tiles and on tiles below a row's window; the
    // running max m is kept in the scores' units, and the scale enters the
    // exponent in f32: p = 2^(s * scale_log2 - m * scale_log2), one fma
    const bool masked = p0 + FA_TILE - 1 > min_lim || p0 < max_lo;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < FA_TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 8 * j + 2 * qd + (e & 1);
        if (masked && (p > lim[e >> 1] || p < lo[e >> 1])) s[j][e] = NEG_INF;
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
    // p entered l unscaled; the v scales fold into p before the PV product
    if constexpr (Q != 0) {
#pragma unroll
      for (int j = 0; j < FA_TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sf[FA_TILE + 8 * j + 2 * qd + (e & 1)];
    }
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
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
      uint32_t hi[4], lo_[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[2 * kc + (i >> 1)][2 * (i & 1)];
        const float y = s[2 * kc + (i >> 1)][2 * (i & 1) + 1];
        hi[i] = pack_bf16(x, y);
        lo_[i] = pack_bf16(x - __uint_as_float(hi[i] << 16),
                           y - __uint_as_float(hi[i] & 0xFFFF0000u));
      }
#pragma unroll
      for (int jp = 0; jp < DW / 16; ++jp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(vt + swzh<D>(16 * kc + (lane & 15), 2 * (CW / 2 * dh + jp) + (lane >> 4)),
                      b0, b1, b2, b3);
        mma_bf16(o[2 * jp], hi[0], hi[1], hi[2], hi[3], b0, b1);
        mma_bf16(o[2 * jp + 1], hi[0], hi[1], hi[2], hi[3], b2, b3);
        mma_bf16(o[2 * jp], lo_[0], lo_[1], lo_[2], lo_[3], b0, b1);
        mma_bf16(o[2 * jp + 1], lo_[0], lo_[1], lo_[2], lo_[3], b2, b3);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy into the Q buffer has landed; no warp reads Q any more

  // 3. normalise (zeros where no position was seen) and write the warp's
  // rows and head dims, staged through its own part of the Q buffer for
  // 16-byte stores. A sink takes its share of the row's softmax here: the
  // row's (m, l) and the sink's (sink, 1) merged, O rescaled with them.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (sinks != nullptr) {
      const int head = h * group + (16 * rw + g + 8 * i) % group;
      const float su = sinks[head] * (LOG2E_F / scale_log2);  // in the scores' units
      const float m = fmaxf(m_run[i], su), f = ex2((m_run[i] - m) * scale_log2);
      inv[i] = f / fmaxf(fmaf(l, f, ex2((su - m) * scale_log2)), 1e-20f);
    } else {
      inv[i] = 1.f / fmaxf(l, 1e-20f);
    }
  }
  uint8_t* stage = fa_smem + L::QOFF;
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * rw + g + 8 * i;
      *reinterpret_cast<uint32_t*>(stage + swzh<D>(r, CW * dh + j) + 4 * qd) =
          pack_bf16(o[j][2 * i] * inv[i], o[j][2 * i + 1] * inv[i]);
    }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 16 * CW / 32; ++k) {
    const int i = lane + 32 * k;
    const int r = 16 * rw + i / CW, c = CW * dh + i % CW;
    const int t = t_begin + r / group;
    if (t < T && r < real)
      *reinterpret_cast<uint4*>(out + (((size_t)b * T + t) * n_q + h * group + r % group) * D +
                                c * 8) = *reinterpret_cast<const uint4*>(stage + swzh<D>(r, c));
  }
}


// ---------------------------------------------------------------------------
// decode: split-KV flash decode on the tensor cores. grid (splits, n_kv, B);
// NT = 8-column tiles of query heads (1: groups up to 8, 2: up to 16)
// ---------------------------------------------------------------------------

constexpr int DC_STAGES = 2;  // K/V tiles in the cp.async ring

// Shared memory of the decode kernel's forms: Q = 0 holds two stages of bf16
// K/V tiles (32 KB at head_dim 64; 64 KB at 128: three blocks per SM; 128 KB
// at 256: one);
// a quantized form holds one widened bf16 K/V tile, then two stages of code
// tiles and scales, then the widened tile's f32 scales (33 KB at head_dim
// 64; 66.5 KB at 128: three blocks per SM; 129 KB at 256: one). Head dims 80
// and 96 take head_dim 128's bf16 tiles (rows of 256 bytes, pitch_dims):
// 64 KB, or 85 KB and 86.5 KB with their code tiles of D-byte rows.
template <int Q, int D>
struct DcLayout {
  static constexpr int KV_B = FA_TILE * 2 * pitch_dims<D>();  // one bf16 K or V tile
  static constexpr int QC_KV_B = FA_TILE * D;              // one K or V code tile
  static constexpr int STAGE0 = Q ? 2 * KV_B : 0;           // the widened K and V tiles
  static constexpr int STAGE_B = Q ? 2 * QC_KV_B + 2 * QC_SC_B : 2 * KV_B;
  static constexpr int SF = STAGE0 + DC_STAGES * STAGE_B;  // f32 scales [2][64]
  static constexpr int SMEM = SF + (Q ? 2 * FA_TILE * 4 : 0);
  static constexpr int OLD = D + 4;  // f32 stride of a warp's output row in the merge
  static_assert(NWARPS * DC_MAX_GROUP * (OLD + 2) * 4 <= SMEM, "the merge must fit");
  static_assert(D <= THREADS || D % THREADS == 0, "the merges' head dims a thread");
  static constexpr int DPT = (D + THREADS - 1) / THREADS;  // head dims a thread merges
};

// the 8x8 b16 matrix held in the m16n8k16 fragment layout, transposed
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// The score step of one tile for the warp's 16 positions: S^T [16 positions
// x 8 NT heads] = K Q^T, lane (g, q) getting positions g and g + 8 of heads
// 2q and 2q + 1 of each head tile. A quantized form's k scales of the two
// positions (ks0, ks1) multiply the scores first; a softcap then caps them.
// Positions outside [the window's first, the split's end) are masked here
// (those past the end were zero-filled).
template <int NT, bool FOLD, int D, bool CAP>
__device__ __forceinline__ void decode_scores(uint32_t kt, int r0, int lane,
                                              const uint32_t (&qb)[NT][D / 16][2],
                                              bool in0, bool in1, float ks0, float ks1,
                                              float softcap, float cap_in, float (&s)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a0, a1, a2, a3;
    ldsm_x4(kt + swzh<D>(r0 + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * kc + (lane >> 4)), a0,
            a1, a2, a3);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(s[nt], a0, a1, a2, a3, qb[nt][kc][0], qb[nt][kc][1]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if constexpr (FOLD) {
      s[nt][0] *= ks0;
      s[nt][1] *= ks0;
      s[nt][2] *= ks1;
      s[nt][3] *= ks1;
    }
    if constexpr (CAP) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = capped(s[nt][e], softcap, cap_in);
    }
    if (!in0) s[nt][0] = s[nt][1] = NEG_INF;
    if (!in1) s[nt][2] = s[nt][3] = NEG_INF;
  }
}

template <int NT, int Q, int D, bool CAP>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 4 : (D <= HD ? 3 : 1))
split_decode_kernel(const __nv_bfloat16* __restrict__ q, uint8_t* k_pool, uint8_t* v_pool,
                    __nv_bfloat16* k_scale, __nv_bfloat16* v_scale,
                    const __nv_bfloat16* __restrict__ k_new,
                    const __nv_bfloat16* __restrict__ v_new, const int* __restrict__ slots,
                    const int* __restrict__ block_tables, const int* __restrict__ kv_lens,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                    int* __restrict__ counters, const float* __restrict__ sinks, int n_q,
                    int n_kv, int S, int W, int bs, int span, int splits, int window,
                    float softcap, float cap_in, float scale_log2) {
  using L = DcLayout<Q, D>;
  constexpr bool FP8 = Q == 2;
  constexpr int ROW_B = Q ? D : 2 * D;  // bytes of a pool row
  constexpr int OLD = L::OLD;
  extern __shared__ __align__(128) uint8_t dc_smem[];
  __shared__ int s_last;
  const uint32_t sa = smem_u32(dc_smem);
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int group = n_q / n_kv;
  const int kv_len = kv_lens[b];
  // A sliding window hides the positions below kv_len - window (p_lo): the
  // walk starts at the tile that holds it, and the plan's splits cover
  // [start, kv_len) only
  const int win = window;
  const int start = win > 0 && kv_len > win ? (kv_len - win) / FA_TILE * FA_TILE : 0;
  const int p_lo = win > 0 ? kv_len - win : 0;
  // splits that hold a position (split 0 alone for kv_len 0)
  const int live = kv_len - start > span ? (kv_len - start + span - 1) / span : 1;
  if (s >= live) return;
  const int p_begin = start + s * span;
  const int p_end = min(p_begin + span, kv_len);

  // 1. this step's K/V row -> slots[b] (slot < 0: dropped), by the split
  // holding position kv_len - 1, before the reads below (a quantized form:
  // warp 0 quantizes the K row, warp 1 the V row, codes and scale written
  // before the barrier, as the bf16 row is)
  const int slot = slots[b];
  if constexpr (Q == 0) {
    if (slot >= 0 && s == live - 1 && tid < 2 * (D / 8)) {
      const int c = tid % (D / 8);
      const size_t src = ((size_t)b * n_kv + h) * D + c * 8;
      const size_t dst = ((size_t)h * S + slot) * ROW_B + c * 16;
      if (tid < D / 8)
        *reinterpret_cast<uint4*>(k_pool + dst) = *reinterpret_cast<const uint4*>(k_new + src);
      else
        *reinterpret_cast<uint4*>(v_pool + dst) = *reinterpret_cast<const uint4*>(v_new + src);
    }
  } else {
    if (slot >= 0 && s == live - 1 && warp < 2) {
      const size_t src = ((size_t)b * n_kv + h) * D;
      const size_t at = (size_t)h * S + slot;
      if (warp == 0)
        quant_write_row<FP8, D>(k_new + src, k_pool + at * ROW_B, k_scale + at, lane);
      else
        quant_write_row<FP8, D>(v_new + src, v_pool + at * ROW_B, v_scale + at, lane);
    }
  }
  __syncthreads();

  // 2. the group's queries as B fragments: head 8 nt + g (zeros past the
  // group), head dims 16 kc + 2q (+1) and + 8
  uint32_t qb[NT][D / 16][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int head = 8 * nt + g;
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        q + ((size_t)b * n_q + h * group + (head < group ? head : 0)) * D + 2 * qd);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      qb[nt][kc][0] = head < group ? qr[8 * kc] : 0u;
      qb[nt][kc][1] = head < group ? qr[8 * kc + 4] : 0u;
    }
  }

  // 3. the K/V tiles of [p_begin, p_end) in order into the ring. Thread:
  // chunk tc = tid % CPR of rows tr + RPP j (tr = tid / CPR; at head_dim 80
  // and 96 the threads past whole rows copy nothing); (blk, off0) is its
  // first row's table entry and offset in the block, advanced by additions.
  // A quantized form's code rows the same way, CPR chunks of D bytes; its
  // scales: threads 0-15, 8 positions each (K below 8, V from 8).
  const int* table = block_tables + (size_t)b * W;
  const size_t pool_h = (size_t)h * S;
  constexpr int CPR = ROW_B / 16;   // 16-byte chunks of a pool row
  using Passes = CopyPasses<CPR, THREADS>;
  constexpr int RPP = Passes::RPP;  // rows a pass of the block copies
  const int tr = (int)((unsigned)tid / CPR), tc = (int)((unsigned)tid % CPR);
  const bool copier = tid < RPP * CPR;
  int blk = (p_begin + tr) / bs, off0 = (p_begin + tr) % bs;
  int sblk = (p_begin + 8 * (tid & 7)) / bs, soff = (p_begin + 8 * (tid & 7)) % bs;
  auto load_kv = [&](int buf, int p0) {
    const uint32_t st = sa + L::STAGE0 + buf * L::STAGE_B;
    const int c = tc;
    int bj = blk, oj = off0;
#pragma unroll
    for (int j = 0; j < Passes::N; ++j) {
      const int r = tr + RPP * j;
      const bool row = Passes::every_row || (copier && r < FA_TILE);
      const bool ok = row && p0 + r < p_end;
      const size_t off = ok ? (pool_h + (size_t)table[bj] * bs + oj) * ROW_B + c * 16 : 0;
      if (row) {
        if constexpr (Q == 0) {
          cp_async16(st + swzh<D>(r, c), k_pool + off, ok);
          cp_async16(st + L::KV_B + swzh<D>(r, c), v_pool + off, ok);
        } else {
          cp_async16(st + r * ROW_B + c * 16, k_pool + off, ok);
          cp_async16(st + L::QC_KV_B + r * ROW_B + c * 16, v_pool + off, ok);
        }
      }
      for (oj += RPP; oj >= bs; oj -= bs) ++bj;
    }
    for (off0 += FA_TILE; off0 >= bs; off0 -= bs) ++blk;
    if constexpr (Q != 0) {
      if (tid < 16) {
        const bool ok = p0 + 8 * (tid & 7) < p_end;
        const size_t at = ok ? pool_h + (size_t)table[sblk] * bs + soff : 0;
        cp_async16(st + 2 * L::QC_KV_B + (tid >> 3) * QC_SC_B + 16 * (tid & 7),
                   (tid < 8 ? k_scale : v_scale) + at, ok);
        for (soff += FA_TILE; soff >= bs; soff -= bs) ++sblk;
      }
    }
  };
  // A quantized form's landed tile in slot buf, widened: warp w widens rows
  // 16 w ... 16 w + 15 of K and V into the bf16 tile; threads take the
  // scales of one position each to f32 (0 past the split's end)
  float* sf = reinterpret_cast<float*>(dc_smem + L::SF);  // k scales [64], v scales [64]
  auto widen = [&](int buf, int p0) {
    const uint8_t* st = dc_smem + L::STAGE0 + buf * L::STAGE_B;
    for (int i = 0; i < 32; ++i) {
      const int r = 16 * warp + (i >> 1), kv = i & 1;
      widen_row<FP8, D>(st + kv * L::QC_KV_B, dc_smem + kv * L::KV_B, r, lane);
    }
    const int r = tid & (FA_TILE - 1), kv = tid / FA_TILE;
    const float f = __bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(st + 2 * L::QC_KV_B + kv * QC_SC_B)[r]);
    sf[tid] = p0 + r < p_end ? f : 0.f;
  };

  float o[NT][D / 16][4];  // O^T [D head dims x 8 NT heads], f32
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) o[nt][dt][0] = o[nt][dt][1] = o[nt][dt][2] = o[nt][dt][3] = 0.f;
  float m_run[NT][2], l_run[NT][2];  // heads 2q, 2q + 1 of each head tile
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m_run[nt][0] = m_run[nt][1] = NEG_INF;
    l_run[nt][0] = l_run[nt][1] = 0.f;
  }

  const int n_tiles = (p_end - p_begin + FA_TILE - 1) / FA_TILE;
  const int r0 = 16 * warp;  // the warp's positions in a tile
#pragma unroll
  for (int i = 0; i < DC_STAGES - 1; ++i) {
    if (i < n_tiles) load_kv(i, p_begin + i * FA_TILE);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<DC_STAGES - 2>();
    __syncthreads();  // this tile has landed for every thread; the slot refilled below is free
    const int nxt = it + DC_STAGES - 1;
    if (nxt < n_tiles) load_kv(nxt % DC_STAGES, p_begin + nxt * FA_TILE);
    cp_async_commit();
    if constexpr (Q != 0) {
      widen(it % DC_STAGES, p_begin + it * FA_TILE);
      __syncthreads();  // the widened tile and its scales, for every warp
    }
    const uint32_t kt = sa + (Q ? 0 : (it % DC_STAGES) * L::STAGE_B), vt = kt + L::KV_B;
    const int pw = p_begin + it * FA_TILE + r0 + g;
    float sc[NT][4];
    decode_scores<NT, Q != 0, D, CAP>(kt, r0, lane, qb, pw >= p_lo && pw < p_end,
                                      pw + 8 >= p_lo && pw + 8 < p_end, Q ? sf[r0 + g] : 1.f,
                                      Q ? sf[r0 + g + 8] : 1.f, softcap, cap_in, sc);

    // online softmax per head; the running max in the scores' units, the
    // scale inside the exponent: p = 2^(s * scale_log2 - m * scale_log2)
    uint32_t bh[NT][2], bl[NT][2];  // P^T as B fragments: hi and lo parts
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = fmaxf(sc[nt][e], sc[nt][2 + e]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m_run[nt][e], mx);
        const float alpha = ex2((m_run[nt][e] - m_new) * scale_log2);
        const float mc = m_new * scale_log2;
        m_run[nt][e] = m_new;
        p[e] = sc[nt][e] > 0.5f * NEG_INF ? ex2(fmaf(sc[nt][e], scale_log2, -mc)) : 0.f;
        p[2 + e] = sc[nt][2 + e] > 0.5f * NEG_INF ? ex2(fmaf(sc[nt][2 + e], scale_log2, -mc)) : 0.f;
        l_run[nt][e] = l_run[nt][e] * alpha + p[e] + p[2 + e];  // the lane's share
#pragma unroll
        for (int dt = 0; dt < D / 16; ++dt) {
          o[nt][dt][e] *= alpha;
          o[nt][dt][2 + e] *= alpha;
        }
      }
      if constexpr (Q != 0) {  // p entered l unscaled; the v scales fold in before PV
        const float vs0 = sf[FA_TILE + r0 + g], vs1 = sf[FA_TILE + r0 + g + 8];
        p[0] *= vs0;
        p[1] *= vs0;
        p[2] *= vs1;
        p[3] *= vs1;
      }
      // (position g | g + 8, heads 2q, 2q + 1) -> (positions 2q, 2q + 1 |
      // + 8, head g): the B fragment of P^T, by movmatrix
      const uint32_t h0 = pack_bf16(p[0], p[1]), h1 = pack_bf16(p[2], p[3]);
      const uint32_t l0 = pack_bf16(p[0] - __uint_as_float(h0 << 16),
                                    p[1] - __uint_as_float(h0 & 0xFFFF0000u));
      const uint32_t l1 = pack_bf16(p[2] - __uint_as_float(h1 << 16),
                                    p[3] - __uint_as_float(h1 & 0xFFFF0000u));
      bh[nt][0] = movmatrix_t(h0);
      bh[nt][1] = movmatrix_t(h1);
      bl[nt][0] = movmatrix_t(l0);
      bl[nt][1] = movmatrix_t(l1);
    }
    // O^T += V^T P^T: V^T [16 head dims x 16 positions] by ldmatrix.trans
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      uint32_t a0, a1, a2, a3;
      ldsm_x4_trans(vt + swzh<D>(r0 + (lane & 7) + ((lane >> 4) << 3), 2 * dt + ((lane >> 3) & 1)),
                    a0, a1, a2, a3);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_bf16(o[nt][dt], a0, a1, a2, a3, bh[nt][0], bh[nt][1]);
        mma_bf16(o[nt][dt], a0, a1, a2, a3, bl[nt][0], bl[nt][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the merge

  // 4. merge the 4 warps in warp order: each warp's (m, l) and O^T rows per
  // head into shared memory, then thread d combines head dims d, d + 128
  // (threads past D idle at head_dim 64); a sequence that fits this split
  // takes its sink here
  float* so = reinterpret_cast<float*>(dc_smem);  // [warp][head][OLD]
  float* sml = so + NWARPS * DC_MAX_GROUP * OLD;  // [warp][head][2]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float l = l_run[nt][e];
      l += __shfl_xor_sync(0xffffffffu, l, 4);
      l += __shfl_xor_sync(0xffffffffu, l, 8);
      l += __shfl_xor_sync(0xffffffffu, l, 16);
      const int head = 8 * nt + 2 * qd + e, row = warp * DC_MAX_GROUP + head;
      if (g == 0) {
        sml[2 * row] = m_run[nt][e];
        sml[2 * row + 1] = l;
      }
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        so[row * OLD + 16 * dt + g] = o[nt][dt][e];
        so[row * OLD + 16 * dt + g + 8] = o[nt][dt][2 + e];
      }
    }
  __syncthreads();
  const size_t row0 = (size_t)b * n_q + h * group;  // the group's first query head
  float* pacc = part;                                        // [B, n_q, splits, D]
  float* pml = part + (size_t)gridDim.z * n_q * splits * D;  // [B, n_q, splits, 2]
  const bool sink_here = live == 1 && sinks != nullptr;
  for (int hh = 0; hh < group; ++hh) {
    float mb = NEG_INF, su = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mb = fmaxf(mb, sml[2 * (w * DC_MAX_GROUP + hh)]);
    if (sink_here) {
      su = sinks[row0 - (size_t)b * n_q + hh] * (LOG2E_F / scale_log2);  // the scores' units
      mb = fmaxf(mb, su);
    }
    float f[NWARPS], l = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const int row = w * DC_MAX_GROUP + hh;
      f[w] = ex2((sml[2 * row] - mb) * scale_log2);
      l = fmaf(f[w], sml[2 * row + 1], l);
    }
    if (sink_here) l += ex2((su - mb) * scale_log2);
    const size_t at = (row0 + hh) * splits + s;
#pragma unroll
    for (int i = 0; i < L::DPT; ++i) {
      const int d = tid + THREADS * i;
      if (D % THREADS != 0 && d >= D) break;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) acc = fmaf(f[w], so[(w * DC_MAX_GROUP + hh) * OLD + d], acc);
      if (live == 1)
        out[(row0 + hh) * D + d] = __float2bfloat16_rn(acc / fmaxf(l, 1e-20f));
      else
        pacc[at * D + d] = acc;
    }
    if (live != 1 && tid == 0) {
      pml[2 * at] = mb;
      pml[2 * at + 1] = l;
    }
  }
  if (live == 1) return;

  // 5. the last split block of (b, h) to arrive merges the splits in order,
  // then the sink
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + (size_t)b * n_kv + h, 1) == live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int hh = 0; hh < group; ++hh) {
    const size_t at = (row0 + hh) * splits;
    float mb = NEG_INF, su = 0.f;
    for (int sp = 0; sp < live; ++sp) mb = fmaxf(mb, __ldcg(pml + 2 * (at + sp)));
    if (sinks != nullptr) {
      su = sinks[row0 - (size_t)b * n_q + hh] * (LOG2E_F / scale_log2);
      mb = fmaxf(mb, su);
    }
#pragma unroll
    for (int i = 0; i < L::DPT; ++i) {
      const int d = tid + THREADS * i;
      if (D % THREADS != 0 && d >= D) break;
      float acc = 0.f, l = 0.f;
      for (int sp = 0; sp < live; ++sp) {
        const float f = ex2((__ldcg(pml + 2 * (at + sp)) - mb) * scale_log2);
        acc = fmaf(f, __ldcg(pacc + (at + sp) * D + d), acc);
        l = fmaf(f, __ldcg(pml + 2 * (at + sp) + 1), l);
      }
      if (sinks != nullptr) l += ex2((su - mb) * scale_log2);
      out[(row0 + hh) * D + d] = __float2bfloat16_rn(acc / fmaxf(l, 1e-20f));
    }
  }
  if (tid == 0) counters[(size_t)b * n_kv + h] = 0;  // ready for the next call
}

template <int NT, int Q, int D, bool CAP>
cudaError_t launch_decode(const __nv_bfloat16* q, uint8_t* k_pool, uint8_t* v_pool,
                          __nv_bfloat16* k_scale, __nv_bfloat16* v_scale,
                          const __nv_bfloat16* k_new, const __nv_bfloat16* v_new,
                          const int* slots, const int* block_tables, const int* kv_lens,
                          __nv_bfloat16* out, float* part, int* counters, const float* sinks,
                          int B, int n_q, int n_kv, int S, int W, int bs, int span, int splits,
                          int window, float softcap, float cap_in, float scale_log2,
                          cudaStream_t st) {
  constexpr int smem = DcLayout<Q, D>::SMEM;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      split_decode_kernel<NT, Q, D, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return opt_in;
  split_decode_kernel<NT, Q, D, CAP><<<dim3(splits, n_kv, B), THREADS, smem, st>>>(
      q, k_pool, v_pool, k_scale, v_scale, k_new, v_new, slots, block_tables, kv_lens, out, part,
      counters, sinks, n_q, n_kv, S, W, bs, span, splits, window, softcap, cap_in, scale_log2);
  return cudaSuccess;
}

template <int Q, int D>
cudaError_t launch_decode_q(const void* q, void* k_pool, void* v_pool, void* k_scale,
                            void* v_scale, const void* k_new, const void* v_new, const void* slots,
                            const void* block_tables, const void* kv_lens, void* out,
                            void* partials, void* counters, const void* sinks, int B, int n_q,
                            int n_kv, int S, int W, int bs, int span, int splits, int window,
                            float softcap, float cap_in, float scale_log2, cudaStream_t st) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<uint8_t*>(k_pool);
  auto* vp = static_cast<uint8_t*>(v_pool);
  auto* ks = static_cast<__nv_bfloat16*>(k_scale);
  auto* vs = static_cast<__nv_bfloat16*>(v_scale);
  const auto* kn = static_cast<const __nv_bfloat16*>(k_new);
  const auto* vn = static_cast<const __nv_bfloat16*>(v_new);
  const auto* sl = static_cast<const int*>(slots);
  const auto* bt = static_cast<const int*>(block_tables);
  const auto* kl = static_cast<const int*>(kv_lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* pp = static_cast<float*>(partials);
  auto* cp = static_cast<int*>(counters);
  const auto* sk = static_cast<const float*>(sinks);
  // a softcap is its own instance (CAP), so the forms without one run no tanh code
  const bool wide = n_q / n_kv > 8;
  if (softcap > 0.f)
    return (wide ? launch_decode<2, Q, D, true> : launch_decode<1, Q, D, true>)(
        qp, kp, vp, ks, vs, kn, vn, sl, bt, kl, op, pp, cp, sk, B, n_q, n_kv, S, W, bs, span,
        splits, window, softcap, cap_in, scale_log2, st);
  return (wide ? launch_decode<2, Q, D, false> : launch_decode<1, Q, D, false>)(
      qp, kp, vp, ks, vs, kn, vn, sl, bt, kl, op, pp, cp, sk, B, n_q, n_kv, S, W, bs, span,
      splits, window, softcap, cap_in, scale_log2, st);
}

template <int Q, int D, bool CAP>
cudaError_t launch_prefill(const void* q, void* k_pool, void* v_pool, void* k_scale,
                           void* v_scale, const void* k_new, const void* v_new, const void* slots,
                           const void* block_tables, const void* kv_lens, const void* n_valid,
                           void* out, const void* sinks, int B, int T, int n_q, int n_kv, int S,
                           int W, int bs, int window, float softcap, float cap_in,
                           float scale_log2, cudaStream_t st, void* k_rt = nullptr,
                           void* v_rt = nullptr) {
  using L = PfLayout<Q, D>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      paged_prefill_kernel<Q, D, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (opt_in != cudaSuccess) return opt_in;
  if constexpr (Q != 0) {  // the chunk's rows: written, and round-tripped for the attention
    quant_chunk_kernel<Q == 2, D><<<dim3((T * n_kv + 1) / 2, B), THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
        static_cast<const int*>(slots), static_cast<const int*>(n_valid),
        static_cast<uint8_t*>(k_pool), static_cast<uint8_t*>(v_pool),
        static_cast<__nv_bfloat16*>(k_scale), static_cast<__nv_bfloat16*>(v_scale),
        static_cast<__nv_bfloat16*>(k_rt), static_cast<__nv_bfloat16*>(v_rt), T, n_kv, S);
    k_new = k_rt;
    v_new = v_rt;
  }
  const int qtok = FA_ROWS / (n_q / n_kv);
  dim3 grid((T + qtok - 1) / qtok, n_kv, B);
  paged_prefill_kernel<Q, D, CAP><<<grid, L::THREADS, L::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<uint8_t*>(k_pool),
      static_cast<uint8_t*>(v_pool), static_cast<__nv_bfloat16*>(k_scale),
      static_cast<__nv_bfloat16*>(v_scale), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<const int*>(slots),
      static_cast<const int*>(block_tables), static_cast<const int*>(kv_lens),
      static_cast<const int*>(n_valid), static_cast<__nv_bfloat16*>(out),
      static_cast<const float*>(sinks), T, n_q, n_kv, S, W, bs, window, softcap, cap_in,
      scale_log2);
  return cudaSuccess;
}

}  // namespace

namespace mrt_pa {

template <int D>
cudaError_t decode_forms(int qkind, const Args& a) {
  auto* f = qkind == 0 ? launch_decode_q<0, D> : qkind == 1 ? launch_decode_q<1, D>
                                                             : launch_decode_q<2, D>;
  return f(a.q, a.k_pool, a.v_pool, a.k_scale, a.v_scale, a.k_new, a.v_new, a.slots,
           a.block_tables, a.kv_lens, a.out, a.partials, a.counters, a.sinks, a.B, a.n_q,
           a.n_kv, a.S, a.W, a.bs, a.span, a.splits, a.window, a.softcap, a.cap_in,
           a.scale_log2, a.stream);
}

// a softcap is its own instance (CAP), so the forms without one run no tanh code
template <int D>
cudaError_t prefill_forms(int qkind, const Args& a) {
  const bool cap = a.softcap > 0.f;
  auto* f = qkind == 0 ? (cap ? launch_prefill<0, D, true> : launch_prefill<0, D, false>)
            : qkind == 1 ? (cap ? launch_prefill<1, D, true> : launch_prefill<1, D, false>)
                         : (cap ? launch_prefill<2, D, true> : launch_prefill<2, D, false>);
  return f(a.q, a.k_pool, a.v_pool, a.k_scale, a.v_scale, a.k_new, a.v_new, a.slots,
           a.block_tables, a.kv_lens, a.n_valid, a.out, a.sinks, a.B, a.T, a.n_q, a.n_kv, a.S,
           a.W, a.bs, a.window, a.softcap, a.cap_in, a.scale_log2, a.stream, a.k_rt, a.v_rt);
}

}  // namespace mrt_pa

// head dim D's forms, compiled in the translation unit that expands this
#define MRT_PA_INSTANTIATE(D)                                              \
  template cudaError_t mrt_pa::decode_forms<D>(int, const mrt_pa::Args&); \
  template cudaError_t mrt_pa::prefill_forms<D>(int, const mrt_pa::Args&);

#endif  // PA_ENTRY_ONLY
#endif  // MRT_PAGED_ATTENTION_CUH
