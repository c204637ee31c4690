"""The port's int8 and fp8-e4m3 paged KV cache against the JAX package on the
CPU: ``write_kv``/``gather_kv`` with scales, the plain versions of the
quantized decode and prefill kernels against the JAX Pallas kernels with
``kv_scale`` (interpret mode, as the JAX package's own tests run them),
``forward_paged`` and the engine (greedy tokens, the uncaptured decode step)
against the JAX package's XLA path, the cache sizing, ``cli serve
--kv-quant``, and DeepSeek's 1-byte latent pool.

The port keeps its scales head-major (``[n_kv, S]`` per layer); the JAX
package packs them slot-major into ``[S, SW]`` (k scales in lanes 0:n_kv, v
in n_kv:2 n_kv). :func:`packed` converts the port's planes to JAX's, and
the tests compare values, not the planes' bytes. Codes are compared as
bytes.

Tolerances: codes and bf16 scales bit-equal (the same f32 arithmetic: a
true division, half-to-even rounding, a round-to-nearest-even e4m3 cast),
except at the trash slot, where dropped writes land in any order. The JAX
kernels in interpret mode do not always divide exactly: where their
quotient rounds across a rounding midpoint, their code is the neighbour of
the exact one. So the kernels' tests hold the port's codes bit-equal to an
independent numpy quantization (IEEE f32 division) and JAX's equal to it
but at such midpoints (:func:`check_codes`). The plain
decode against the JAX decode kernel: 1e-4 (f32 inputs; exp against exp2,
sum order). The plain prefill against the JAX prefill kernel: 1e-2 (the JAX
kernel rounds P to bf16 for its PV product; the plain version keeps f32),
and 1e-1 on the query rows that attend to a chunk row the JAX kernel
quantized across a midpoint (one code step of a K or V value).
``forward_paged`` against the JAX XLA path, f32: 1e-2 of the largest logit
(the prefill's own chunk attends to bf16(code x s) in the port, as the JAX
kernel does, and to code x bf16(s) in the XLA path); DeepSeek's latent
path: 1e-4 (the same codes and keys on both sides); greedy tokens
identical. The kernel's inputs are rows of bf16 values (the kernels take
bf16 rows; the JAX kernels round f32 rows to bf16 first).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mistralrs_tpu.engine.adapters import DeepseekAdapter as JaxAdapter
from mistralrs_tpu.engine.engine import Engine as JaxEngine
from mistralrs_tpu.engine.sampler import SamplingParams as JaxParams
from mistralrs_tpu.kv.paged import PagedKVCache as JaxCache
from mistralrs_tpu.kv.paged import gather_kv as jax_gather
from mistralrs_tpu.kv.paged import write_kv as jax_write
from mistralrs_tpu.models import deepseek as jds
from mistralrs_tpu.models.llama import forward_paged as jax_forward
from mistralrs_tpu.ops.paged_attention import (
    paged_decode_attention_fused as jax_decode,
    paged_prefill_attention_fused as jax_prefill,
)
from mistralrs_tpu_torch import cli
from mistralrs_tpu_torch.engine.adapters import DeepseekAdapter
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.kv.paged import (
    CODE_DTYPES,
    PagedKVCache,
    calculate_cache_config,
    gather_kv,
    quantize_rows,
    write_kv,
)
from mistralrs_tpu_torch.models import deepseek as tds
from mistralrs_tpu_torch.models.llama import forward_paged
from mistralrs_tpu_torch.ops import paged_attention as pa
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.paged_attention import (
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)

from test_torch_deepseek import V2, both, close
from test_torch_engine import CFG, JCFG, JW, TW
from test_torch_llama import BS as LBS
from test_torch_llama import _schedule

QUANTS = ["int8", "fp8"]
JAX_CODES = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def u8(t) -> np.ndarray:
    """A code array's bytes (port tensor or JAX array)."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.asarray(jax.lax.bitcast_convert_type(t, jnp.uint8))


def to_jax_codes(t: torch.Tensor, kv_quant: str):
    return jax.lax.bitcast_convert_type(jnp.asarray(u8(t)), JAX_CODES[kv_quant])


def packed(ks: torch.Tensor, vs: torch.Tensor, sw: int = 128):
    """The port's scale planes [..., n_kv, S] → the JAX package's packed
    slot-major plane [..., S, SW] (bf16)."""
    n_kv = ks.shape[-2]
    out = np.zeros(ks.shape[:-2] + (ks.shape[-1], sw), np.float32)
    out[..., :n_kv] = np.swapaxes(ks.float().numpy(), -1, -2)
    out[..., n_kv:2 * n_kv] = np.swapaxes(vs.float().numpy(), -1, -2)
    return jnp.asarray(out, jnp.bfloat16)


def check_scales(ks, vs, kvs, skip_trash=True):
    """The port's scale planes hold the JAX packed plane's values."""
    ref = np.asarray(jnp.asarray(kvs, jnp.float32))
    n_kv = ks.shape[-2]
    end = -1 if skip_trash else None
    np.testing.assert_array_equal(ks.float().numpy()[..., :end],
                                  np.swapaxes(ref[..., :end, :n_kv], -1, -2))
    np.testing.assert_array_equal(vs.float().numpy()[..., :end],
                                  np.swapaxes(ref[..., :end, n_kv:2 * n_kv], -1, -2))


def quant_pools(rng, n_kv, s_total, hd, kv_quant):
    """Code pools of random rows and their scales (port layout); slot 5 of
    head 0 an all-zero row."""
    out = []
    for _ in range(2):
        rows = torch.from_numpy(rng.standard_normal((n_kv, s_total, hd)).astype(np.float32))
        rows = rows.to(torch.bfloat16)
        rows[0, 5] = 0
        codes, s = quantize_rows(rows, CODE_DTYPES[kv_quant])
        out += [codes, s.to(torch.bfloat16)]
    return out  # k, k_scale, v, v_scale


def exact_quant(x, kv_quant):
    """numpy's quantization of f32 rows ``x`` [..., hd] (an IEEE f32
    division): (code bytes, the f32 quotients, the bf16 scales as f32)."""
    import ml_dtypes

    x = np.asarray(x, np.float32)
    amax = np.abs(x).max(-1)
    s = (amax / np.float32(127.0 if kv_quant == "int8" else 448.0)).astype(np.float32)
    y = (x / np.maximum(s, np.float32(1e-10))[..., None]).astype(np.float32)
    if kv_quant == "int8":
        codes = np.clip(np.rint(y), -127, 127).astype(np.int8).view(np.uint8)
    else:
        codes = y.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    return codes, y, s.astype(ml_dtypes.bfloat16).astype(np.float32)


def code_values(b, kv_quant):
    import ml_dtypes

    dt = np.int8 if kv_quant == "int8" else ml_dtypes.float8_e4m3fn
    return b.view(dt).astype(np.float64)


def expected_pool(pool_u8, scale, rows, slots, kv_quant):
    """The pool bytes, the quotients (NaN where nothing was written) and the
    scale plane after writing ``rows`` [N, n_kv, hd] at ``slots`` [N]
    (slot < 0 dropped), by :func:`exact_quant`."""
    codes, y, s = exact_quant(rows, kv_quant)
    pool = pool_u8.copy()
    ys = np.full(pool.shape, np.nan, np.float32)
    sc = scale.float().numpy().copy()
    for i, slot in enumerate(np.asarray(slots).reshape(-1)):
        if slot >= 0:
            pool[:, slot], ys[:, slot], sc[:, slot] = codes[i], y[i], s[i]
    return pool, ys, sc


def check_codes(port, jax_codes, ref, ys, kv_quant):
    """The port's code bytes equal the exact ones; JAX's too, but where its
    quotient fell across a rounding midpoint: there its code is the exact
    one's neighbour and the exact quotient lies within 1e-5 of the
    midpoint (trash slot left out)."""
    port, jax_codes, ref, ys = port[:, :-1], jax_codes[:, :-1], ref[:, :-1], ys[:, :-1]
    np.testing.assert_array_equal(port, ref)
    off = jax_codes != ref
    assert off.mean() < 1e-3, off.sum()
    a, b = code_values(ref[off], kv_quant), code_values(jax_codes[off], kv_quant)
    mid = (a + b) / 2
    assert np.all(np.abs(ys[off] - mid) <= 1e-5 * np.abs(mid)), (ys[off], a, b)
    return np.argwhere(off.any(-1))  # (head, slot) of the rows JAX rounded otherwise


def bf16_valued(rng, *shape):
    """f32 rows holding bf16 values (the kernels' rows are bf16)."""
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(torch.bfloat16).float().numpy())


# ---------------------------------------------------------------------------
# write_kv / gather_kv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kv_quant", QUANTS)
def test_write_kv_matches_jax(kv_quant, rows_dtype):
    """Codes (as bytes) and bf16 scales bit-equal to JAX ``write_kv``, with
    a dropped slot (-1) and an all-zero row (code 0, scale 0), except at the
    trash slot."""
    n_kv, hd, bs, nb = 2, 64, 16, 6
    s_total = (nb + 1) * bs
    rng = np.random.default_rng(1)
    t = 40
    k = rng.standard_normal((t, n_kv, hd)).astype(np.float32) * 3
    v = rng.standard_normal((t, n_kv, hd)).astype(np.float32)
    k[7] = 0
    v[7, 1] = 0
    slots = rng.permutation(nb * bs)[:t].astype(np.int32)
    slots[11] = -1
    tdt = torch.float32 if rows_dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if rows_dtype == "f32" else jnp.bfloat16
    code = CODE_DTYPES[kv_quant]
    kp = torch.zeros((n_kv, s_total, hd), dtype=code)
    vp = torch.zeros_like(kp)
    ks = torch.zeros((n_kv, s_total), dtype=torch.bfloat16)
    vs = torch.zeros_like(ks)
    write_kv(kp, vp, torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
             torch.from_numpy(slots), ks, vs)
    jk, jv, jkvs = jax_write(
        jnp.zeros((n_kv, s_total, hd), JAX_CODES[kv_quant]),
        jnp.zeros((n_kv, s_total, hd), JAX_CODES[kv_quant]),
        jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(slots),
        jnp.zeros((s_total, 128), jnp.bfloat16))
    np.testing.assert_array_equal(u8(kp)[:, :-1], u8(jk)[:, :-1])
    np.testing.assert_array_equal(u8(vp)[:, :-1], u8(jv)[:, :-1])
    check_scales(ks, vs, jkvs)
    z = int(slots[7])
    assert (u8(kp)[:, z] == 0).all() and (ks[:, z] == 0).all() and vs[1, z] == 0


@pytest.mark.parametrize("kv_quant", QUANTS)
def test_gather_kv_matches_jax(kv_quant):
    """``gather_kv`` with scales, in f32: bit-equal to JAX's."""
    n_kv, hd, bs, nb = 2, 64, 16, 8
    rng = np.random.default_rng(2)
    kp, ks, vp, vs = quant_pools(rng, n_kv, (nb + 1) * bs, hd, kv_quant)
    bt = rng.permutation(nb).astype(np.int32).reshape(2, 4)
    bt[1, 3] = -1  # padding
    hk, hv = gather_kv(kp, vp, torch.from_numpy(bt), bs, dtype=torch.float32, k_scale=ks,
                       v_scale=vs)
    jk, jv = jax_gather(to_jax_codes(kp, kv_quant), to_jax_codes(vp, kv_quant),
                        jnp.asarray(bt), bs, packed(ks, vs), dtype=jnp.float32)
    np.testing.assert_array_equal(hk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(hv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# the plain kernels against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------

HD, BS, W = 128, 16, 6


def _slot(bt, b, p):
    return int(bt[b, p // BS] * BS + p % BS)


def decode_case(kv_quant, group, seed=3):
    """3 rows: kv_len 69 (a past not a multiple of 64), kv_len 0 (slot -1),
    kv_len 96 (the whole table); row 2's step rows are all zero."""
    n_kv, b = 2, 3
    rng = np.random.default_rng(seed)
    s_total = (b * W + 1) * BS
    pools = quant_pools(rng, n_kv, s_total, HD, kv_quant)
    bt = rng.permutation(b * W).astype(np.int32).reshape(b, W)
    kv_lens = np.array([69, 0, W * BS], np.int32)
    slots = np.array([_slot(bt, 0, 68), -1, _slot(bt, 2, W * BS - 1)], np.int32)
    q = rng.standard_normal((b, n_kv * group, HD)).astype(np.float32)
    kn = bf16_valued(rng, b, n_kv, HD)
    vn = bf16_valued(rng, b, n_kv, HD)
    kn[2] = 0
    vn[2] = 0
    return pools, (q, kn, vn, slots, bt, kv_lens)


def run_decode_both(kv_quant, group):
    pools, (q, kn, vn, slots, bt, kv_lens) = decode_case(kv_quant, group)
    k, ks, v, vs = pools
    jo, jk, jv, jkvs = jax_decode(
        jnp.asarray(q), to_jax_codes(k, kv_quant), to_jax_codes(v, kv_quant), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(slots), jnp.asarray(bt), jnp.asarray(kv_lens), 0, 0,
        packed(ks, vs), block_size=BS, interpret=True)
    mine = [t.clone() for t in pools]
    reset_counts()
    to = paged_decode_attention_fused(
        torch.from_numpy(q), mine[0], mine[2], torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(slots), torch.from_numpy(bt), torch.from_numpy(kv_lens),
        block_size=BS, k_scale=mine[1], v_scale=mine[3])
    return to, np.asarray(jo), mine, (jk, jv, jkvs), kv_lens


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("kv_quant", QUANTS)
def test_decode_plain_matches_pallas(kv_quant, group):
    """The plain quantized decode against JAX ``paged_decode_attention_fused``
    with ``kv_scale``: output within 1e-4, kv_len 0 giving zeros, the step's
    codes and scales bit-equal (an all-zero row: code 0, scale 0)."""
    to, jo, mine, (jk, jv, jkvs), _ = run_decode_both(kv_quant, group)
    assert COUNTS[f"paged_decode_{kv_quant}_plain"] == 1 and COUNTS["paged_decode_plain"] == 0
    np.testing.assert_allclose(to.numpy(), jo, atol=1e-4)
    assert (to[1] == 0).all()
    pools, (_, kn, vn, slots, _, _) = decode_case(kv_quant, group)
    for new, i, jc in ((kn, 0, jk), (vn, 2, jv)):
        ref, ys, sc = expected_pool(u8(pools[i]), pools[i + 1], new, slots, kv_quant)
        check_codes(u8(mine[i]), u8(jc), ref, ys, kv_quant)
        np.testing.assert_array_equal(mine[i + 1].float().numpy()[:, :-1], sc[:, :-1])
    check_scales(mine[1], mine[3], jkvs)


def test_decode_fold_order_is_checked(monkeypatch):
    """A plain version that folds the v scale into p before the running sum
    l takes it (semantic 2 broken) is caught by the comparison above."""

    def wrong(q, k, v, allowed, ks=None, vs=None, softcap=0.0, sink=None):
        s = torch.einsum("bkrd,bkpd->bkrp", q, k) * ks[:, :, None, :]
        s = torch.where(allowed, s, torch.full_like(s, pa.NEG_INF))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * allowed * vs[:, :, None, :]
        return torch.einsum("bkrp,bkpd->bkrd", p, v) / p.sum(-1, keepdim=True).clamp_min(1e-20)

    monkeypatch.setattr(pa, "_softmax_attend", wrong)
    to, jo, *_ = run_decode_both("int8", 4)
    assert np.abs(to.numpy() - jo).max() > 1e-4 * 100


def prefill_case(kv_quant, group, seed=4):
    """3 rows of a 20-token chunk: 20 valid on a past of 25, 7 valid on
    none, 12 valid on 40 (rows 1 and 2: n_valid < T)."""
    n_kv, b, t = 2, 3, 20
    rng = np.random.default_rng(seed)
    s_total = (b * W + 1) * BS
    pools = quant_pools(rng, n_kv, s_total, HD, kv_quant)
    bt = rng.permutation(b * W).astype(np.int32).reshape(b, W)
    n_valid = np.array([20, 7, 12], np.int32)
    kv_lens = n_valid + np.array([25, 0, 40], np.int32)
    ctx = kv_lens - n_valid
    slots = np.full((b, t), -1, np.int32)
    for i in range(b):
        slots[i, :n_valid[i]] = [_slot(bt, i, ctx[i] + j) for j in range(n_valid[i])]
    q = rng.standard_normal((b, t, n_kv * group, HD)).astype(np.float32)
    kn = bf16_valued(rng, b, t, n_kv, HD)
    vn = bf16_valued(rng, b, t, n_kv, HD)
    kn[0, 3] = 0
    vn[0, 3] = 0
    return pools, (q, kn, vn, slots, bt, kv_lens, n_valid)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("kv_quant", QUANTS)
def test_prefill_plain_matches_pallas(kv_quant, group):
    """The plain quantized prefill against JAX
    ``paged_prefill_attention_fused`` with ``kv_scale``: valid rows within
    1e-2, the chunk's codes and scales bit-equal."""
    pools, (q, kn, vn, slots, bt, kv_lens, n_valid) = prefill_case(kv_quant, group)
    k, ks, v, vs = pools
    jo, jk, jv, jkvs = jax_prefill(
        jnp.asarray(q), to_jax_codes(k, kv_quant), to_jax_codes(v, kv_quant), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(slots), jnp.asarray(bt), jnp.asarray(kv_lens),
        jnp.asarray(n_valid), 0, 0, packed(ks, vs), block_size=BS, interpret=True)
    mine = [t.clone() for t in pools]
    reset_counts()
    to = paged_prefill_attention_fused(
        torch.from_numpy(q), mine[0], mine[2], torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(slots), torch.from_numpy(bt), torch.from_numpy(kv_lens),
        torch.from_numpy(n_valid), block_size=BS, k_scale=mine[1], v_scale=mine[3])
    assert COUNTS[f"paged_prefill_{kv_quant}_plain"] == 1
    b, t, n_kv, _ = kn.shape
    # the query rows that attend to a chunk row whose codes the JAX kernel
    # took across a midpoint (its own tiles read bf16(code x s)): one code
    # step of a K or V value moves them by up to ~4e-2 here
    moved = np.zeros(q.shape[:3], bool)
    for new, i, jc in ((kn, 0, jk), (vn, 2, jv)):
        ref, ys, sc = expected_pool(u8(pools[i]), pools[i + 1], new.reshape(b * t, n_kv, HD),
                                    slots, kv_quant)
        for h, slot in check_codes(u8(mine[i]), u8(jc), ref, ys, kv_quant):
            (r, tok), = np.argwhere(slots == slot)
            moved[r, tok:, h * group:(h + 1) * group] = True
        np.testing.assert_array_equal(mine[i + 1].float().numpy()[:, :-1], sc[:, :-1])
    check_scales(mine[1], mine[3], jkvs)
    jo, got = np.asarray(jo), to.numpy()
    for i, n in enumerate(n_valid):
        err = np.abs(got[i, :n] - jo[i, :n]).max(-1)  # [n, n_q]
        assert (err[~moved[i, :n]] <= 1e-2).all() and (err[moved[i, :n]] <= 1e-1).all()
    assert moved.mean() < 0.5


def test_quantized_pools_need_their_scales():
    q = torch.zeros((1, 2, HD))
    pool = torch.zeros((1, 3 * BS, HD), dtype=torch.int8)
    new = torch.zeros((1, 1, HD))
    i1 = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_decode_attention_fused(q, pool, pool, new, new, i1, i1[None], i1, block_size=BS)


# ---------------------------------------------------------------------------
# the model, the engine, the cache sizing and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", QUANTS)
def test_forward_paged_matches_jax(kv_quant):
    """A 2-row chunked prefill then 3 decode steps over 1-byte pools (f32
    compute): logits within 1e-2 of the largest of JAX ``forward_paged(
    backend="xla")``'s, greedy choices equal; layer 0's codes and scales
    after the prefill bit-equal (both quantize the same f32 rows)."""
    nb = 17
    jc = JaxCache.create(JCFG, nb, LBS, dtype=jnp.float32, kv_quant=kv_quant)
    tc = PagedKVCache.create(CFG, nb, LBS, dtype=torch.float32, kv_quant=kv_quant,
                             device="cpu")
    assert tc.quantized and tc.k.dtype == CODE_DTYPES[kv_quant]
    assert tc.k_scale.shape == (CFG.num_layers, CFG.num_kv_heads, (nb + 1) * LBS)
    bt, steps = _schedule()
    reset_counts()
    for i, (ids, pos, slots, kv_lens, last) in enumerate(steps):
        jl, jc = jax_forward(
            JW, JCFG, jnp.asarray(ids), jnp.asarray(pos), jc, jnp.asarray(bt),
            jnp.asarray(slots), jnp.asarray(kv_lens), block_size=LBS, backend="xla",
            compute_dtype=jnp.float32, last_indices=None if last is None else jnp.asarray(last))
        tl, tc = forward_paged(
            TW, CFG, torch.from_numpy(ids).long(), torch.from_numpy(pos).long(), tc,
            torch.from_numpy(bt), torch.from_numpy(slots), torch.from_numpy(kv_lens),
            block_size=LBS, compute_dtype=torch.float32,
            last_indices=None if last is None else torch.from_numpy(last).long())
        jl = np.asarray(jl, np.float32)
        close(tl.numpy(), jl, tol=1e-2)
        assert (tl.numpy()[:, -1].argmax(-1) == jl[:, -1].argmax(-1)).all()
        if i == 0:
            np.testing.assert_array_equal(u8(tc.k[0])[:, :-1], u8(jc.k[0])[:, :-1])
            np.testing.assert_array_equal(u8(tc.v[0])[:, :-1], u8(jc.v[0])[:, :-1])
            check_scales(tc.k_scale[0], tc.v_scale[0], jc.kv_scale[0])
    assert COUNTS[f"paged_prefill_{kv_quant}_plain"] == CFG.num_layers
    assert COUNTS[f"paged_decode_{kv_quant}_plain"] == 3 * CFG.num_layers


@pytest.mark.parametrize("kv_quant", QUANTS)
def test_engine_greedy_matches_jax(kv_quant):
    """Both engines with ``kv_quant`` serve 3 greedy requests (44-50 prompt
    tokens, 16-token chunks) for 30 tokens each: identical tokens."""
    kw = dict(num_blocks=32, block_size=16, max_batch=4, prefill_chunk=16)
    je = JaxEngine(JCFG, JW, backend="xla", compute_dtype=jnp.float32, kv_quant=kv_quant, **kw)
    te = Engine(CFG, TW, compute_dtype=torch.float32, device="cpu", kv_quant=kv_quant, **kw)
    assert te.cache.quantized
    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(0, 256, 44 + 3 * i)] for i in range(3)]
    js = [je.add_request(p, JaxParams(temperature=0.0, max_tokens=30)) for p in prompts]
    ts = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=30)) for p in prompts]
    je.run_to_completion()
    te.run_to_completion()
    assert [s.generated_ids for s in ts] == [s.generated_ids for s in js]
    assert all(len(s.generated_ids) == 30 for s in ts)


@pytest.mark.parametrize("kv_quant", QUANTS)
def test_decode_step_matches_jax_step(kv_quant):
    """The engine's uncaptured decode step over 1-byte pools, 3 requests past
    their first decode step: from the same pools (the port's, converted to
    the JAX package's layout), its logits are within 1e-4 of the largest of
    JAX ``forward_paged(backend="xla")``'s on the same staging (both fold
    the stored codes and scales the same way, in f32), and its greedy tokens
    are the arg-maxes. (Whole greedy sequences against the JAX engine are
    compared above; the prefill's own chunk attends to bf16(code x s) in
    the port and to code x bf16(s) in the XLA path, so near-tied logits may
    part the two over long runs.)"""
    te = Engine(CFG, TW, compute_dtype=torch.float32, device="cpu", kv_quant=kv_quant,
                num_blocks=32, block_size=16, max_batch=4, prefill_chunk=16)
    rng = np.random.default_rng(9)
    seqs = [te.add_request([int(x) for x in rng.integers(0, 256, 20 + 7 * i)],
                           SamplingParams(temperature=0.0, max_tokens=40)) for i in range(3)]
    while any(len(s.generated_ids) < 2 for s in seqs):
        te.step()
    ds, width, bs = te.decode_step, te._max_blocks_bucket(), te.block_size
    stage = ds.staging(width)
    for s in seqs:
        pos = s.total_len - 1
        table = te.kv.block_table(s.request_id)
        stage[s.slot, :4] = (s.all_ids[-1], pos, table[pos // bs] * bs + pos % bs, pos + 1)
        stage[s.slot, 4:4 + len(table)] = table
    stage = stage.copy()
    c = te.cache
    jcache = JaxCache(to_jax_codes(c.k, kv_quant), to_jax_codes(c.v, kv_quant),
                      packed(c.k_scale, c.v_scale))
    ds.upload(width)
    out = ds.compute(width)
    jl, _ = jax_forward(
        JW, JCFG, jnp.asarray(stage[:, :1]), jnp.asarray(stage[:, 1:2]), jcache,
        jnp.asarray(stage[:, 4:]), jnp.asarray(stage[:, 2:3]), jnp.asarray(stage[:, 3]),
        block_size=bs, backend="xla", compute_dtype=jnp.float32)
    live = [s.slot for s in seqs]
    jl = np.asarray(jl)[live, 0]
    close(out.logits.numpy()[live], jl)
    assert (out.tokens.numpy()[live] == jl.argmax(-1)).all()


def test_cache_config_counts_quantized_bytes():
    """With ``kv_quant`` a token takes 2 L n_kv (hd + 2) bytes: codes and a
    bf16 scale per (layer, head), K and V. (The JAX formula adds its packed
    plane's L * SW * 2 bytes per slot instead of 2 L n_kv * 2.)"""
    per_token = 2 * CFG.num_layers * CFG.num_kv_heads * (CFG.head_dim + 2)
    assert per_token == 144
    kw = dict(block_size=16, max_model_len=10**6, max_batch=1)
    blocks = calculate_cache_config(CFG, kv_quant=True, mem_bytes=1 << 20, utilization=1.0,
                                    **kw)
    assert blocks == (1 << 20) // (per_token * 16) - 1
    bf16 = calculate_cache_config(CFG, mem_bytes=1 << 20, utilization=1.0, **kw)
    assert bf16 == (1 << 20) // (2 * CFG.num_layers * CFG.num_kv_heads * 32 * 16) - 1
    # the port's pools and scales of one block take exactly per_token * 16 bytes
    c = PagedKVCache.create(CFG, 1, 16, kv_quant="int8", device="cpu")
    got = sum(t.numel() * t.element_size() for t in (c.k, c.v, c.k_scale, c.v_scale))
    assert got == 2 * per_token * 16  # two blocks: the one asked for and the trash block


def test_cli_serve_kv_quant_reaches_engine(monkeypatch, tmp_path):
    """``serve --kv-quant int8`` sizes the pools with the quantized bytes per
    token and hands ``kv_quant`` to the engine, which serves from int8
    pools."""
    from mistralrs_tpu_torch import pipeline
    from mistralrs_tpu_torch.chat_template import resolve_chat_template
    from mistralrs_tpu_torch.serving import server

    seen = {}

    class Tok:
        def encode(self, text, add_bos=None):
            return list(text.encode())

    def load(path, isq=None, chat_template_override=None, device=None, from_uqff=None):
        assert from_uqff is None  # no --from-uqff on this command line
        # serve fuses the projections in place: hand it copies of the layer dicts
        weights = {**TW, "layers": [dict(lw) for lw in TW["layers"]]}
        return pipeline.Pipeline(CFG, weights, Tok(), resolve_chat_template(override="x"),
                                 "tiny", {})

    class FakeServer:
        def __init__(self, engine, *a, **kw):
            seen["engine"] = engine
            self.address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

    def sizing(*a, **kw):
        seen["kv_quant"] = kw["kv_quant"]
        return 12

    monkeypatch.setattr(pipeline, "load_pipeline", load)
    monkeypatch.setattr(server, "Server", FakeServer)
    monkeypatch.setattr("mistralrs_tpu_torch.kv.paged.calculate_cache_config", sizing)
    assert cli.main(["serve", str(tmp_path / "m.gguf"), "--device", "cpu", "--kv-quant",
                     "int8", "--max-seq-len", "128"]) == 0
    eng = seen["engine"]
    assert seen["kv_quant"] is True and eng.kv_quant == "int8"
    assert eng.cache.k.dtype == torch.int8 and eng.cache.k.shape[2] == 13 * 64
    with pytest.raises(SystemExit):
        cli.main(["serve", "m.gguf", "--kv-quant", "int4"])


# ---------------------------------------------------------------------------
# DeepSeek: the 1-byte latent pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", QUANTS)
def test_deepseek_quantized_latent_matches_jax(kv_quant):
    """A 2 x 13-token prefill then 3 decode steps over a 1-byte latent pool
    (f32 compute), against JAX ``deepseek_forward_paged`` with its quantized
    pool: logits within 1e-4 of the largest, the codes (the JAX rows are
    zero-padded to 128 lanes) and the scales bit-equal; the decode steps
    take the gather path, not the MLA kernel."""
    jcfg, jw, cfg, tw = both(V2, seed=3)
    bs, nb, t = 4, 24, 13
    rng = np.random.default_rng(4)
    ids = rng.integers(0, V2["vocab_size"], (2, t + 3))
    bt = rng.permutation(nb)[:12].astype(np.int32).reshape(2, 6)
    jcache = jds.make_paged_cache(jcfg, nb, bs, dtype=jnp.float32, kv_quant=kv_quant)
    tcache = tds.make_paged_cache(cfg, nb, bs, dtype=torch.float32, kv_quant=kv_quant,
                                  device="cpu")

    def slot(r, p):
        return bt[r, p // bs] * bs + p % bs

    lens = np.array([t, 9])
    sl = np.array([[slot(r, p) if p < lens[r] else -1 for p in range(t)] for r in range(2)],
                  np.int32)
    steps = [(ids[:, :t], np.tile(np.arange(t), (2, 1)), sl, lens.astype(np.int32), lens - 1)]
    for k in range(3):
        steps.append((ids[:, t + k:t + k + 1], lens[:, None].copy(),
                      np.array([[slot(0, lens[0])], [slot(1, lens[1])]], np.int32),
                      (lens + 1).astype(np.int32), None))
        lens = lens + 1
    reset_counts()
    for i, p, s, kv, last in steps:
        jl, jcache = jds.deepseek_forward_paged(
            jw, jcfg, jnp.asarray(i, jnp.int32), jnp.asarray(p, jnp.int32), jcache,
            jnp.asarray(bt), jnp.asarray(s.reshape(-1)), jnp.asarray(kv), block_size=bs,
            backend="xla", compute_dtype=jnp.float32,
            last_indices=None if last is None else jnp.asarray(last, jnp.int32))
        tl, tcache = tds.deepseek_forward_paged(
            tw, cfg, torch.from_numpy(i), torch.from_numpy(p), tcache, torch.from_numpy(bt),
            torch.from_numpy(s), torch.from_numpy(kv), block_size=bs, compute_dtype=torch.float32,
            last_indices=None if last is None else torch.from_numpy(last))
        close(tl.numpy(), np.asarray(jl))
    assert COUNTS["mla_decode_plain"] == 0 and COUNTS["mla_decode"] == 0
    jpool = np.concatenate([u8(jcache["dense"]), u8(jcache["moe"])])[..., :cfg.row_dim]
    np.testing.assert_array_equal(u8(tcache.pool)[:, :-1], jpool[:, :-1])
    jscale = np.concatenate([np.asarray(jcache["dense_scale"], np.float32),
                             np.asarray(jcache["moe_scale"], np.float32)])[..., 0]
    np.testing.assert_array_equal(tcache.scale.float().numpy()[:, :-1], jscale[:, :-1])


def test_deepseek_engine_kv_quant_matches_jax():
    """Both engines serve 2 greedy requests through the DeepSeek adapter
    from int8 latent pools (the analog of JAX
    ``tests/test_arch_adapters.py::test_deepseek_engine_kv_quant_int8``):
    identical tokens."""
    jcfg, jw, cfg, tw = both(V2, seed=11)
    kw = dict(num_blocks=64, block_size=8, max_batch=4, prefill_chunk=8, kv_quant="int8")
    je = JaxEngine(jcfg, jw, adapter=JaxAdapter(jcfg, jw, backend="xla"), backend="xla",
                   compute_dtype=jnp.float32, **kw)
    te = Engine(cfg, None, adapter=DeepseekAdapter(cfg, tw, compute_dtype=torch.float32,
                                                   device="cpu"), device="cpu", **kw)
    assert te.cache.pool.dtype == torch.int8
    rng = np.random.default_rng(11)
    prompts = [[int(x) for x in rng.integers(1, V2["vocab_size"], n)] for n in (6, 13)]
    js = [je.add_request(p, JaxParams(temperature=0.0, max_tokens=5)) for p in prompts]
    ts = [te.add_request(p, SamplingParams(temperature=0.0, max_tokens=5)) for p in prompts]
    je.run_to_completion()
    te.run_to_completion()
    assert [s.generated_ids for s in ts] == [s.generated_ids for s in js]
    assert all(len(s.generated_ids) == 5 for s in ts)
