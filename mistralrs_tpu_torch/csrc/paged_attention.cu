// The C entry points of the paged decode and prefill kernels (bodies in
// paged_attention.cuh): each checks its arguments, then dispatches to the
// forms of its head dim, compiled one head dim a translation unit
// (paged_attention_hd<D>.cu). PA_HEAD_DIMS lists the head dims linked in (a
// tool that builds one head dim's forms alone defines it first).

#define PA_ENTRY_ONLY
#include "paged_attention.cuh"

#ifndef PA_HEAD_DIMS
#define PA_HEAD_DIMS(X) X(64) X(80) X(96) X(128) X(256)
#endif

namespace {

using mrt_pa::DC_MAX_GROUP;
using mrt_pa::FA_ROWS;
using mrt_pa::FA_TILE;

// The plan must cover every walk: [0, kv_len) with kv_len <= W * bs, or with
// a window [the tile holding kv_len - window, kv_len), < window + 64 positions
bool decode_args_ok(int B, int n_q, int n_kv, int W, int bs, int span, int splits, int window,
                    float softcap, const void* partials, const void* counters) {
  const long long table = (long long)W * bs, win = (long long)window + FA_TILE - 1;
  const long long walk = window > 0 && win < table ? win : table;
  return B >= 0 && n_kv > 0 && n_q % n_kv == 0 && n_q / n_kv <= DC_MAX_GROUP && span > 0 &&
         span % FA_TILE == 0 && splits >= 1 && bs > 0 && window >= 0 && softcap >= 0.f &&
         (long long)splits * span >= walk &&
         (splits == 1 || (partials != nullptr && counters != nullptr));
}

// a query tile holds FA_ROWS / group >= 1 tokens
bool prefill_group_ok(int n_q, int n_kv) {
  return n_kv > 0 && n_q > 0 && n_q % n_kv == 0 && n_q / n_kv <= FA_ROWS;
}

bool head_dim_ok(int hd) {
#define PA_IS(D) hd == D ||
  return PA_HEAD_DIMS(PA_IS) false;
#undef PA_IS
}

cudaError_t decode_form(int hd, int qkind, const mrt_pa::Args& a) {
  switch (hd) {
#define PA_CASE(D) \
  case D:          \
    return mrt_pa::decode_forms<D>(qkind, a);
    PA_HEAD_DIMS(PA_CASE)
#undef PA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t prefill_form(int hd, int qkind, const mrt_pa::Args& a) {
  switch (hd) {
#define PA_CASE(D) \
  case D:          \
    return mrt_pa::prefill_forms<D>(qkind, a);
    PA_HEAD_DIMS(PA_CASE)
#undef PA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, n_q, hd], pools [n_kv, S, hd] (one layer plane), k_new/v_new
// [B, n_kv, hd], slots [B], block_tables [B, W], kv_lens [B] (length after
// this step's write), out [B, n_q, hd]; hd 64, 80, 96, 128 or 256. group = n_q /
// n_kv <= 16. window: 0 (full attention) or the positions a query sees, its
// own included; softcap: 0 (none) or the cap, with cap_in = scale / softcap
// and scale_log2 = log2(e) (else scale * log2(e)); sinks: null (none) or
// f32 [n_q], each head's sink logit. The plan: `splits` splits of
// `span` positions (a multiple of 64) covering the walk (W * bs, or less
// than window + 64 with a window); with splits > 1, partials f32
// [B * n_q * splits * (hd + 2)] and counters int32 [B * n_kv] (all zero,
// left zero).
extern "C" int mrt_paged_decode(const void* q, void* k_pool, void* v_pool, const void* k_new,
                                const void* v_new, const void* slots, const void* block_tables,
                                const void* kv_lens, void* out, void* partials, void* counters,
                                const void* sinks, int B, int n_q, int n_kv, int hd, int window,
                                float softcap, float cap_in, int S, int W, int bs, int span,
                                int splits, float scale_log2, void* stream) {
  if (!decode_args_ok(B, n_q, n_kv, W, bs, span, splits, window, softcap, partials, counters) ||
      !head_dim_ok(hd))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const mrt_pa::Args a{q, k_pool, v_pool, nullptr, nullptr, k_new, v_new, slots,
                       block_tables, kv_lens, nullptr, out, partials, counters, sinks, nullptr,
                       nullptr, B, 1, n_q, n_kv, S, W, bs, span, splits, window, softcap, cap_in,
                       scale_log2, static_cast<cudaStream_t>(stream)};
  const cudaError_t e = decode_form(hd, 0, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The quantized form: pools of 1-byte codes [n_kv, S, hd] (int8, or e4m3
// when fp8 != 0) with bf16 scales k_scale/v_scale [n_kv, S]; bs a multiple
// of 8 (a 16-byte copy of scales stays in one block); the rest, options
// included, as above.
extern "C" int mrt_paged_decode_q(const void* q, void* k_pool, void* v_pool, const void* k_new,
                                  const void* v_new, const void* slots, const void* block_tables,
                                  const void* kv_lens, void* out, void* partials, void* counters,
                                  const void* sinks, int B, int n_q, int n_kv, int hd, int window,
                                  float softcap, float cap_in, int S, int W, int bs, int span,
                                  int splits, float scale_log2, void* k_scale, void* v_scale,
                                  int fp8, void* stream) {
  if (!decode_args_ok(B, n_q, n_kv, W, bs, span, splits, window, softcap, partials, counters) ||
      !head_dim_ok(hd) || bs % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const mrt_pa::Args a{q, k_pool, v_pool, k_scale, v_scale, k_new, v_new, slots,
                       block_tables, kv_lens, nullptr, out, partials, counters, sinks, nullptr,
                       nullptr, B, 1, n_q, n_kv, S, W, bs, span, splits, window, softcap, cap_in,
                       scale_log2, static_cast<cudaStream_t>(stream)};
  const cudaError_t e = decode_form(hd, fp8 ? 2 : 1, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}


// q [B, T, n_q, hd], pools [n_kv, S, hd], k_new/v_new [B, T, n_kv, hd],
// slots [B, T], block_tables [B, W], kv_lens [B] (after the chunk's writes),
// n_valid [B], out [B, T, n_q, hd]; hd 64, 80, 96, 128 or 256. The chunk's valid
// tokens sit at positions [kv_len - n_valid, kv_len). group = n_q / n_kv
// <= 64 (one token a query tile at least). window, softcap, cap_in,
// scale_log2 and sinks as for the decode kernel.
extern "C" int mrt_paged_prefill(const void* q, void* k_pool, void* v_pool, const void* k_new,
                                 const void* v_new, const void* slots, const void* block_tables,
                                 const void* kv_lens, const void* n_valid, void* out,
                                 const void* sinks, int B, int T, int n_q, int n_kv, int hd,
                                 int window, float softcap, float cap_in, int S, int W, int bs,
                                 float scale_log2, void* stream) {
  if (!head_dim_ok(hd) || !prefill_group_ok(n_q, n_kv) || window < 0 || softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  const mrt_pa::Args a{q, k_pool, v_pool, nullptr, nullptr, k_new, v_new, slots,
                       block_tables, kv_lens, n_valid, out, nullptr, nullptr, sinks, nullptr,
                       nullptr, B, T, n_q, n_kv, S, W, bs, 0, 1, window, softcap, cap_in,
                       scale_log2, static_cast<cudaStream_t>(stream)};
  const cudaError_t e = prefill_form(hd, 0, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The quantized form: 1-byte code pools (int8, or e4m3 when fp8 != 0) with
// bf16 scales k_scale/v_scale [n_kv, S]; bs a multiple of 8; k_rt/v_rt
// scratch like k_new/v_new (the chunk's rows' round trips); the rest,
// options included, as above.
extern "C" int mrt_paged_prefill_q(const void* q, void* k_pool, void* v_pool, const void* k_new,
                                   const void* v_new, const void* slots, const void* block_tables,
                                   const void* kv_lens, const void* n_valid, void* out,
                                   const void* sinks, int B, int T, int n_q, int n_kv, int hd,
                                   int window, float softcap, float cap_in, int S, int W, int bs,
                                   float scale_log2, void* k_scale, void* v_scale, int fp8,
                                   void* k_rt, void* v_rt, void* stream) {
  if (!head_dim_ok(hd) || !prefill_group_ok(n_q, n_kv) || window < 0 || softcap < 0.f ||
      bs % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const mrt_pa::Args a{q, k_pool, v_pool, k_scale, v_scale, k_new, v_new, slots,
                       block_tables, kv_lens, n_valid, out, nullptr, nullptr, sinks, k_rt,
                       v_rt, B, T, n_q, n_kv, S, W, bs, 0, 1, window, softcap, cap_in,
                       scale_log2, static_cast<cudaStream_t>(stream)};
  const cudaError_t e = prefill_form(hd, fp8 ? 2 : 1, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
