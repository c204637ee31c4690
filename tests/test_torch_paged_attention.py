"""The plain versions of the port's decode and prefill kernels against the
JAX Pallas kernels (``paged_decode_attention_fused`` /
``paged_prefill_attention_fused``, interpret mode) at head_dim 128 with tiny
batch, chunk and table sizes. Outputs are compared in bf16 (atol 1e-2 on
values of magnitude ~1: one bf16 ulp) and the pools through K/V gathered by
the block tables (exactly), not byte by byte. Covers a dropped write (slot
-1) and a chunk row with n_valid < T."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.kv.paged import gather_kv as jax_gather
from mistralrs_tpu.ops.paged_attention import (
    paged_decode_attention_fused as jax_decode,
    paged_prefill_attention_fused as jax_prefill,
)
from mistralrs_tpu_torch.kv.paged import gather_kv, quantize_rows
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.paged_attention import (
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)

B, N_KV, GROUP, HD, BS, W = 3, 2, 4, 128, 16, 4
N_Q = N_KV * GROUP
S = (B * W + 1) * BS  # + the trash block


def _setup(seed):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((N_KV, S, HD)).astype(np.float32)
    vp = rng.standard_normal((N_KV, S, HD)).astype(np.float32)
    bt = rng.permutation(B * W).astype(np.int32).reshape(B, W)
    return rng, kp, vp, bt


def _slot(bt, b, p):
    return int(bt[b, p // BS] * BS + p % BS)


def _bf(a):
    return jnp.asarray(a, jnp.bfloat16)


def _tb(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _check_gathered(jk, jv, tk, tv, bt, kv_lens):
    gk, gv = jax_gather(jk, jv, jnp.asarray(bt), BS, dtype=jnp.float32)
    hk, hv = gather_kv(tk, tv, torch.from_numpy(bt), BS, dtype=torch.float32)
    for b, n in enumerate(kv_lens):
        np.testing.assert_array_equal(hk.numpy()[b, :n], np.asarray(gk)[b, :n])
        np.testing.assert_array_equal(hv.numpy()[b, :n], np.asarray(gv)[b, :n])


def test_decode_matches_pallas():
    rng, kp, vp, bt = _setup(0)
    kv_lens = np.array([37, 1, 64], np.int32)
    q = rng.standard_normal((B, N_Q, HD)).astype(np.float32)
    kn = rng.standard_normal((B, N_KV, HD)).astype(np.float32)
    vn = rng.standard_normal((B, N_KV, HD)).astype(np.float32)
    # row 1 drops its write (slot -1): it reads the pool's old row instead
    slots = np.array([_slot(bt, 0, 36), -1, _slot(bt, 2, 63)], np.int32)
    jo, jk, jv = jax_decode(_bf(q), _bf(kp), _bf(vp), _bf(kn), _bf(vn),
                            jnp.asarray(slots), jnp.asarray(bt), jnp.asarray(kv_lens),
                            block_size=BS, interpret=True)
    tk, tv = _tb(kp), _tb(vp)
    reset_counts()
    to = paged_decode_attention_fused(
        _tb(q), tk, tv, _tb(kn), _tb(vn), torch.from_numpy(slots), torch.from_numpy(bt),
        torch.from_numpy(kv_lens), block_size=BS)
    assert COUNTS["paged_decode_plain"] == 1 and COUNTS["paged_decode"] == 0
    assert to.dtype == torch.bfloat16 and to.shape == (B, N_Q, HD)
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32), atol=1e-2)
    _check_gathered(jk, jv, tk, tv, bt, kv_lens)
    # the dropped write left row 1's last position untouched
    np.testing.assert_array_equal(
        tk[:, _slot(bt, 1, 0)].float().numpy(), _tb(kp)[:, _slot(bt, 1, 0)].float().numpy())


def test_prefill_matches_pallas():
    rng, kp, vp, bt = _setup(1)
    T = 20
    n_valid = np.array([20, 7, 12], np.int32)  # rows 1 and 2: n_valid < T
    kv_lens = n_valid + np.array([25, 0, 40], np.int32)
    ctx = kv_lens - n_valid
    slots = np.full((B, T), -1, np.int32)
    for b in range(B):
        slots[b, : n_valid[b]] = [_slot(bt, b, ctx[b] + t) for t in range(n_valid[b])]
    q = rng.standard_normal((B, T, N_Q, HD)).astype(np.float32)
    kn = rng.standard_normal((B, T, N_KV, HD)).astype(np.float32)
    vn = rng.standard_normal((B, T, N_KV, HD)).astype(np.float32)
    jo, jk, jv = jax_prefill(_bf(q), _bf(kp), _bf(vp), _bf(kn), _bf(vn),
                             jnp.asarray(slots), jnp.asarray(bt), jnp.asarray(kv_lens),
                             jnp.asarray(n_valid), block_size=BS, interpret=True)
    tk, tv = _tb(kp), _tb(vp)
    reset_counts()
    to = paged_prefill_attention_fused(
        _tb(q), tk, tv, _tb(kn), _tb(vn), torch.from_numpy(slots), torch.from_numpy(bt),
        torch.from_numpy(kv_lens), torch.from_numpy(n_valid), block_size=BS)
    assert COUNTS["paged_prefill_plain"] == 1 and COUNTS["paged_prefill"] == 0
    jo = np.asarray(jo, np.float32)
    for b in range(B):  # rows past n_valid are never read
        np.testing.assert_allclose(to.float().numpy()[b, : n_valid[b]],
                                   jo[b, : n_valid[b]], atol=1e-2)
    _check_gathered(jk, jv, tk, tv, bt, kv_lens)


def test_four_dim_pools_touch_only_their_layer():
    """[L, n_kv, S, hd] pools: the layer argument selects the plane written."""
    rng, kp, vp, bt = _setup(2)
    k4 = torch.zeros((3, N_KV, S, HD), dtype=torch.bfloat16)
    v4 = torch.zeros_like(k4)
    kv_lens = torch.tensor([5, 9, 2], dtype=torch.int32)
    slots = torch.tensor([_slot(bt, b, int(kv_lens[b]) - 1) for b in range(B)],
                         dtype=torch.int32)
    kn = _tb(rng.standard_normal((B, N_KV, HD)))
    paged_decode_attention_fused(
        _tb(rng.standard_normal((B, N_Q, HD))), k4, v4, kn, kn, slots,
        torch.from_numpy(bt), kv_lens, 1, block_size=BS)
    assert k4[0].abs().sum() == 0 and k4[2].abs().sum() == 0
    torch.testing.assert_close(k4[1][:, slots.long()], kn.transpose(0, 1), rtol=0, atol=0)


def test_unported_options_raise():
    """Sinks and a sliding window on a 1-byte pool, which the quantized
    forms once refused, compute: each call (the int8 form's plain version)
    equals the f32 plain version over the same values dequantized, the
    step's row as it reads back from the pool (code x bf16(s)), within
    1e-5, and differs from the call without the option by more than
    1e-2."""
    rng = np.random.default_rng(12)
    rows = [_tb(rng.standard_normal((N_KV, S, HD))) for _ in range(2)]
    coded = [quantize_rows(r, torch.int8) for r in rows]
    codes = [c for c, _ in coded]
    scales = [sc.to(torch.bfloat16) for _, sc in coded]
    deq = [c.float() * sc.float()[..., None] for c, sc in zip(codes, scales)]
    q = torch.from_numpy(rng.standard_normal((1, N_Q, HD)).astype(np.float32))
    new = [_tb(rng.standard_normal((1, N_KV, HD))).float() for _ in range(2)]
    back = []  # the step's rows as they read back from the pool
    for x in new:
        c, sc = quantize_rows(x, torch.int8)
        back.append(c.float() * sc.to(torch.bfloat16).float()[..., None])
    bt = torch.arange(W, dtype=torch.int32)[None]
    kv_len = torch.tensor([45], dtype=torch.int32)
    slot = torch.tensor([44], dtype=torch.int32)
    sinks = torch.from_numpy(rng.standard_normal(N_Q).astype(np.float32) * 2 + 1)
    for opts in (dict(sinks=sinks), dict(window=8)):
        reset_counts()
        got = paged_decode_attention_fused(q, codes[0].clone(), codes[1].clone(), *new, slot, bt,
                                           kv_len, block_size=BS, k_scale=scales[0].clone(),
                                           v_scale=scales[1].clone(), **opts)
        assert COUNTS["paged_decode_int8_plain"] == 1 and sum(COUNTS.values()) == 1
        want = paged_decode_attention_fused(q, deq[0].clone(), deq[1].clone(), *back, slot, bt,
                                            kv_len, block_size=BS, **opts)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        without = paged_decode_attention_fused(q, deq[0].clone(), deq[1].clone(), *back, slot,
                                               bt, kv_len, block_size=BS)
        assert (want - without).abs().max() > 1e-2