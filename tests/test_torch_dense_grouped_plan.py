"""The dense grouped kernel's plan and arithmetic on the CPU.

``dense_grouped_plan`` names the dense grouped kernel's body
(``csrc/dense_grouped.cu``) for a row tile, a static shape: 16-row tiles
take the decode body in 64-column blocks, each walking all of K; 64-row
tiles take the wgmma prefill body in 256-column blocks. The tests pin the
plan at the DeepSeek-V2-Lite and Mixtral-8x7B serve shapes and show that
the wrapper hands the kernel the same arguments whatever the routing:
driven with a fake kernel library on meta tensors (which hold no values, so
no routing or used-tile count can be read on the host) and on CPU tensors
of different routings.

A plain model of both bodies' arithmetic (per used tile, the f32 products
of its rows with its expert's weight over each 64-k step, summed in step
order, one rounding to bf16; unused tiles zero) is held against JAX
``_dense_matmul_g`` (``backend="pallas"`` in interpret mode and
``backend="xla"``) and the port's plain version in bf16 (1e-2 of the
largest |output|), and against the plain version's f32 product (atol 1e-5
on outputs of magnitude ~1: the f32 sum order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.ops.moe_grouped import dense_matmul_grouped as jax_dense_g
from mistralrs_tpu_torch.ops import moe_grouped as mg
from mistralrs_tpu_torch.ops.moe_grouped import (
    build_groups,
    dense_grouped_plan,
    dense_matmul_grouped,
    grouped_tile,
)

STEP = 64  # k per step of both bodies


def _mp(pairs, e, tm):
    """build_groups' static padded row count for ``pairs`` (token, choice)
    pairs over ``e`` experts."""
    return -(-(pairs + min(e, pairs) * (tm - 1)) // tm) * tm


# (E, N, K, top-k): DeepSeek-V2-Lite's gate/up and down banks, Mixtral-8x7B's
# bf16 down bank
BANKS = {"v2lite_gateup": (64, 2816, 2048, 6), "v2lite_down": (64, 2048, 1408, 6),
         "mixtral_down": (8, 4096, 14336, 2)}


@pytest.mark.parametrize("tokens", [1, 2, 6, 8, 96, 512])
@pytest.mark.parametrize("bank", list(BANKS))
def test_plan_at_serve_shapes(bank, tokens):
    """Decode steps (16-row tiles) take the decode body, prefill chunks
    (64-row tiles) the prefill body; both tile K in whole 64-k steps."""
    e, n, k, top = BANKS[bank]
    tm = grouped_tile(tokens * top)
    plan = dense_grouped_plan(tm)
    assert plan == (("decode", 64) if tm == 16 else ("prefill", 256))
    assert k % STEP == 0 and _mp(tokens * top, e, tm) % tm == 0


def test_plan_at_the_chip_smoke_rows():
    """Phase 2's rows: V2-Lite's decode steps of 1 and 6 tokens and Mixtral's
    of 8 (16-row tiles), the 2 x 96-token and 512-token prefill chunks."""
    for pairs in (6, 36, 16):
        assert dense_grouped_plan(grouped_tile(pairs)) == ("decode", 64)
    for pairs in (1152, 1024):
        assert dense_grouped_plan(grouped_tile(pairs)) == ("prefill", 256)


def test_plan_refuses_other_row_tiles():
    with pytest.raises(ValueError, match="row tile"):
        dense_grouped_plan(32)


class _FakeLibrary:
    """Records the dense grouped kernel's launch arguments."""

    def __init__(self):
        self.calls = []

    def mrt_dense_matmul_grouped(self, *args):
        self.calls.append(args)
        return 0


def _launch(monkeypatch, device, topi, n, e=8, k=512):
    fake = _FakeLibrary()
    monkeypatch.setattr(mg, "library", lambda: fake)
    monkeypatch.setattr(mg, "stream_ptr", lambda t: 0)
    tm = grouped_tile(topi.numel())
    _, _, _, tiles, n_used, mp = build_groups(topi, torch.ones(topi.shape), e, tm)
    w = torch.zeros((e, n, k), dtype=torch.bfloat16, device=device)
    x = torch.zeros((mp, k), dtype=torch.bfloat16, device=device)
    mg._dense_matmul_grouped_cuda(x, w, tiles.to(device), n_used.to(device), tm)
    (args,) = fake.calls
    return args[5:10]  # M, N, K, tm, bank stride


@pytest.mark.parametrize("tokens,n", [(2, 320), (8, 4096), (512, 320)])
def test_plan_reads_no_device_value(monkeypatch, tokens, n):
    """8 experts of [n, 512], top-2: two decode steps and a 512-token
    prefill chunk. The launch needs no value from the device, and every
    routing gets the same arguments."""
    ref = _launch(monkeypatch, "meta", torch.zeros((tokens, 2), dtype=torch.long), n)
    tm = grouped_tile(2 * tokens)
    assert ref == (_mp(2 * tokens, 8, tm), n, 512, tm, n * 512)
    rng = np.random.default_rng(tokens)
    for topi in (np.zeros((tokens, 2)), np.full((tokens, 2), 7), rng.integers(0, 8, (tokens, 2))):
        assert _launch(monkeypatch, "cpu", torch.from_numpy(topi).long(), n) == ref


# ---------------------------------------------------------------------------
# both bodies' arithmetic, modelled in f32
# ---------------------------------------------------------------------------


def _emulate(xs, bank, tiles, n_used, tm):
    """Both bodies' arithmetic in f32: per used tile, the f32 products over
    each 64-k step summed in step order; unused tiles zero."""
    k = xs.shape[1]
    out = torch.zeros((xs.shape[0], bank.shape[1]))
    for t in range(int(n_used)):
        rows = slice(t * tm, (t + 1) * tm)
        w = bank[int(tiles[t])].float()
        acc = torch.zeros((tm, bank.shape[1]))
        for k0 in range(0, k, STEP):
            acc = acc + xs[rows, k0:k0 + STEP].float() @ w[:, k0:k0 + STEP].T
        out[rows] = acc
    return out


@pytest.mark.parametrize("tm", [16, 64])
@pytest.mark.parametrize("routing", ["ragged", "all_to_one", "empty_expert"])
def test_step_arithmetic_matches_jax_and_plain(routing, tm):
    """8 experts of [96, 512] in bf16 (8 steps of 64 k), 10 tokens top-2 in
    16-row tiles (the decode body) or 64-row tiles (the prefill body)."""
    e, n, k, ntok = 8, 96, 512, 10
    rng = np.random.default_rng(tm)
    topi = {"ragged": rng.integers(0, e, (ntok, 2)), "all_to_one": np.full((ntok, 2), e - 1),
            "empty_expert": rng.choice([x for x in range(e) if x != 2], (ntok, 2))}[routing]
    bank = torch.from_numpy(rng.standard_normal((e, n, k)).astype(np.float32) * 0.05).to(
        torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((ntok, k)).astype(np.float32)).to(torch.bfloat16)
    st, dest, _, tiles, n_used, mp = build_groups(torch.from_numpy(topi), torch.ones(ntok, 2),
                                                  e, tm)
    xs = torch.zeros((mp, k), dtype=torch.bfloat16)
    xs[dest] = x[st]
    got = _emulate(xs, bank, tiles, n_used, tm)
    jb = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    top = got.abs().max().item()
    used = int(n_used) * tm  # JAX computes every tile; the port zeros unused ones
    for backend in ("pallas", "xla"):
        ref = jax_dense_g(jb(xs), jb(bank), jnp.asarray(tiles.numpy()), tm=tm, backend=backend,
                          interpret=backend == "pallas")
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy()[:used], ref[:used],
                                   atol=1e-2 * top)
    assert (got[used:] == 0).all()
    plain = dense_matmul_grouped(xs, bank, tiles, tm=tm, n_used_tiles=n_used)
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), plain.float().numpy(),
                               atol=1e-2 * top)
    plain32 = dense_matmul_grouped(xs.float(), bank, tiles, tm=tm, n_used_tiles=n_used)
    np.testing.assert_allclose(got.numpy(), plain32.numpy(), atol=1e-5)
