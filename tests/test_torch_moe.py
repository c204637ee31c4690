"""The port's mixture-of-experts path against the JAX package's on the CPU:
``build_groups`` (exactly), the plain grouped matmuls (against
``quant_matmul_grouped`` / ``dense_matmul_grouped`` on the XLA path and, on
tiny cases, the Pallas kernels in interpret mode), ``moe_grouped_mlp``,
``_moe_mlp`` for both ported routers, and a tiny 2-layer Mixtral through
``forward_paged`` with weights carried by ``from_jax_params`` or loaded from
a tiny GGUF by each package's own loader.

Inputs come from numpy seeds. Tolerances: with the same bf16 rounding of
inputs and weights in both packages only the order of f32 sums differs
(rtol/atol 1e-5 of outputs of magnitude ~1), and the chosen experts are
compared for equality before any output is. Whole models run f32 compute,
but both packages round each expert's input rows to bf16 for the grouped
products (the JAX default dequant dtype, also in f32 compute), so a
last-bit f32 difference from the layers before can flip one rounding
(2^-8 relative) of one token's expert input; that token's K/V in the next
layer then differ and so do later logits. Logits agree within 1e-2 of the
largest |logit| (measured: up to 3.4e-3) with correlation > 0.9999; a wrong
expert or weight gives differences of the logits' own size.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mistralrs_tpu.gguf.constants import GGMLType as JaxType
from mistralrs_tpu.gguf.planar import to_planar as jax_to_planar
from mistralrs_tpu.gguf.planar import widen_planar
from mistralrs_tpu.gguf.quants import quantize
from mistralrs_tpu.gguf.writer import GGUFWriter
from mistralrs_tpu.kv.paged import PagedKVCache as JaxCache
from mistralrs_tpu.models.config import ModelConfig as JaxConfig
from mistralrs_tpu.models import gguf_loader as jax_loader
from mistralrs_tpu.models.gguf_loader import load_gguf_model as jax_load_gguf
from mistralrs_tpu.models.llama import _moe_mlp as jax_moe_mlp
from mistralrs_tpu.models.llama import forward_paged as jax_forward
from mistralrs_tpu.models.llama import init_random_weights as jax_init
from mistralrs_tpu.ops.moe_grouped import build_groups as jax_build_groups
from mistralrs_tpu.ops.moe_grouped import dense_matmul_grouped as jax_dense_g
from mistralrs_tpu.ops.moe_grouped import moe_grouped_mlp as jax_moe_grouped
from mistralrs_tpu.ops.quant_matmul import quant_matmul_grouped as jax_qmm_g
from mistralrs_tpu.quant.linear import linear as jax_linear
from mistralrs_tpu.quant.qtensor import QTensor as JaxQTensor
from mistralrs_tpu_torch.convert import from_jax_params
from mistralrs_tpu_torch.gguf.constants import GGMLType
from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.gguf_loader import load_gguf_model
from mistralrs_tpu_torch.models.llama import (
    _moe_mlp,
    forward_paged,
    fuse_projections,
    init_random_weights,
    route,
)
from mistralrs_tpu_torch.ops._cuda import COUNTS, reset_counts
from mistralrs_tpu_torch.ops.moe_grouped import (
    build_groups,
    dense_matmul_grouped,
    moe_grouped_mlp,
)
from mistralrs_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_grouped
from mistralrs_tpu_torch.quant.linear import linear
from mistralrs_tpu_torch.quant.qtensor import QTensor

from test_torch_llama import BS, _schedule, jax_to_numpy

E, H, I = 4, 256, 512


def _jax_bank(rng, e, n, k, kind):
    """A stacked ``[e, n, k]`` bank in both packages → (jax leaf, port leaf).
    kind: a GGML type name, "widened" (Q4_K re-expressed as int8 / group 16
    with a bias plane, as the JAX loader stacks mixed layers) or "dense"."""
    w = (rng.standard_normal((e, n, k)) * 0.05).astype(np.float32)
    if kind == "dense":
        return jnp.asarray(w), torch.from_numpy(w)
    ggml = JaxType["Q4_K" if kind == "widened" else kind]
    raws = [np.asarray(quantize(w[i], ggml), np.uint8) for i in range(e)]
    if kind == "widened":
        qts = [JaxQTensor.from_planar(widen_planar(jax_to_planar(r, ggml)), (n, k))
               for r in raws]
    else:
        qts = [JaxQTensor.from_gguf_raw(r, ggml, (n, k)) for r in raws]
    jbank = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *qts)
    if kind == "widened":
        planes = jax_to_numpy(jbank)
        tbank = QTensor(*(torch.from_numpy(planes[f].copy()) for f in ("data", "scale", "bias")),
                        group_size=16, packed=False, code_bits=8)
    else:  # the port's own bank constructor from the [E, N, K] tensor's bytes
        tbank = QTensor.from_gguf_raw(np.concatenate(raws), GGMLType[kind], (e, n, k),
                                      device="cpu")
    return jbank, tbank


def _routing(name, n, k=2, e=E, seed=0):
    rng = np.random.default_rng(seed)
    if name == "ragged":
        topi = rng.integers(0, e, (n, k))
    elif name == "all_to_one":
        topi = np.full((n, k), e - 1)
    else:  # "empty_expert": expert 1 gets nothing
        topi = rng.choice([x for x in range(e) if x != 1], (n, k))
    topw = rng.uniform(0.1, 1.0, (n, k)).astype(np.float32)
    return topi.astype(np.int32), topw


def _sorted_rows(routing, n, tm, h=H, seed=5):
    """Rows sorted and padded by both packages' build_groups → (jax args,
    port args, mp); the padding rows are zero."""
    topi, topw = routing
    x = np.random.default_rng(seed).standard_normal((n, h)).astype(np.float32)
    st, dest, _, tile_idx, mp = jax_build_groups(jnp.asarray(topi), jnp.asarray(topw), E, tm)
    xs = jnp.zeros((mp, h), jnp.float32).at[dest].set(jnp.asarray(x)[st])
    t_st, t_dest, _, t_tiles, n_used, t_mp = build_groups(
        torch.from_numpy(topi), torch.from_numpy(topw), E, tm)
    txs = torch.zeros((t_mp, h))
    txs[t_dest] = torch.from_numpy(x)[t_st]
    return (xs, tile_idx), (txs, t_tiles, n_used), mp


@pytest.mark.parametrize("routing,n,k,tm", [
    ("ragged", 16, 2, 8), ("ragged", 8, 2, 16), ("ragged", 150, 2, 64),
    ("all_to_one", 8, 2, 8), ("empty_expert", 24, 2, 16), ("ragged", 5, 3, 4),
])
def test_build_groups_matches_jax_exactly(routing, n, k, tm):
    topi, topw = _routing(routing, n, k)
    ref = jax_build_groups(jnp.asarray(topi), jnp.asarray(topw), E, tm)
    st, dest, sw, tile_idx, n_used, mp = build_groups(
        torch.from_numpy(topi), torch.from_numpy(topw), E, tm)
    assert mp == ref[4]
    for got, want in zip((st, dest, sw, tile_idx), ref[:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tile_idx.dtype == torch.int32 and n_used.dtype == torch.int32
    sizes = np.bincount(topi.reshape(-1), minlength=E)
    assert int(n_used) == int(sum(-(-s // tm) for s in sizes))


@pytest.mark.parametrize("kind", ["Q4_K", "Q6_K", "Q8_0", "widened"])
@pytest.mark.parametrize("routing", ["ragged", "empty_expert"])
def test_grouped_plain_matches_xla(kind, routing):
    """f32 inputs and f32 dequant in both: only the f32 sum order differs
    (rtol/atol 1e-5); used tiles only are computed by the port, and the
    unused ones are zero in both (their rows are zero padding)."""
    rng = np.random.default_rng(1)
    jbank, tbank = _jax_bank(rng, E, I, H, kind)
    (xs, tiles), (txs, t_tiles, n_used), mp = _sorted_rows(_routing(routing, 12), 12, 16)
    ref = jax_qmm_g(xs, jbank, tiles, tm=16, backend="xla", dequant_dtype=jnp.float32,
                    out_dtype=jnp.float32)
    reset_counts()
    got = quant_matmul_grouped(txs, tbank, t_tiles, tm=16, n_used_tiles=n_used,
                               compute_dtype=torch.float32)
    name = "w4_matmul_g" if tbank.packed else "w8_matmul_g"
    assert COUNTS == {name + "_plain": 1}
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # bf16 dequant in both (the serving dtype): the same bf16 weights
    ref16 = jax_qmm_g(xs, jbank, tiles, tm=16, backend="xla", out_dtype=jnp.float32)
    got16 = quant_matmul_grouped(txs, tbank, t_tiles, tm=16, n_used_tiles=n_used,
                                 out_dtype=torch.float32)
    np.testing.assert_allclose(got16.numpy(), np.asarray(ref16), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="bank"):
        quant_matmul(txs, tbank)  # a bank takes the grouped entry point


@pytest.mark.parametrize("kind", ["Q4_K", "Q6_K"])
def test_grouped_plain_matches_pallas_interpret(kind):
    """The JAX grouped Pallas kernel (interpret mode) on a tiny case: the
    bias term rides the kernel as a second product there, so the sums are
    ordered differently (rtol/atol 2e-4)."""
    rng = np.random.default_rng(2)
    jbank, tbank = _jax_bank(rng, E, 256, H, kind)
    (xs, tiles), (txs, t_tiles, n_used), _ = _sorted_rows(_routing("ragged", 6, seed=3), 6, 16)
    ref = jax_qmm_g(xs, jbank, tiles, tm=16, backend="pallas", interpret=True,
                    dequant_dtype=jnp.float32, out_dtype=jnp.float32)
    got = quant_matmul_grouped(txs, tbank, t_tiles, tm=16, n_used_tiles=n_used,
                               compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_dense_grouped_plain_matches_jax(backend):
    """f32 rows and bank: rtol/atol 1e-5 (sum order)."""
    rng = np.random.default_rng(3)
    jbank, tbank = _jax_bank(rng, E, I, H, "dense")
    (xs, tiles), (txs, t_tiles, n_used), _ = _sorted_rows(_routing("empty_expert", 12), 12, 16)
    ref = jax_dense_g(xs, jbank, tiles, tm=16, backend=backend,
                      interpret=backend == "pallas")
    reset_counts()
    got = dense_matmul_grouped(txs, tbank, t_tiles, tm=16, n_used_tiles=n_used)
    assert COUNTS == {"dense_matmul_g_plain": 1}
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _banks(kinds, seed=4):
    rng = np.random.default_rng(seed)
    shapes = {"gate": (I, H), "up": (I, H), "down": (H, I)}
    pairs = {key: _jax_bank(rng, E, *shapes[key], kinds[key]) for key in shapes}
    return ({key: p[0] for key, p in pairs.items()}, {key: p[1] for key, p in pairs.items()})


MIXED = {"gate": "Q4_K", "up": "Q4_K", "down": "Q6_K"}
F16_DOWN = {"gate": "Q4_K", "up": "Q4_K", "down": "dense"}
DENSE = {"gate": "dense", "up": "dense", "down": "dense"}


@pytest.mark.parametrize("kinds", [MIXED, F16_DOWN], ids=["q4k_q6k", "q4k_dense_down"])
@pytest.mark.parametrize("n", [8, 140])
def test_moe_grouped_mlp_matches_jax(kinds, n):
    """f32 tokens. With f32 dequant in both only the f32 sum order differs
    (rtol/atol 1e-5). With bf16 dequant (the serving dtype) both round the
    hidden activations to bf16 before the down product, where a last-bit
    difference can flip one rounding: atol 2e-3 on outputs of magnitude ~1
    (one bf16 ulp, 2^-8, of a hidden value times a down weight sum). n = 140
    takes the port's 64-row tile, n = 8 its 16-row tile (JAX: 16 both)."""
    jexp, texp = _banks(kinds)
    topi, topw = _routing("ragged", n, seed=6)
    x = np.random.default_rng(7).standard_normal((n, H)).astype(np.float32)
    args = (torch.from_numpy(x), texp, torch.from_numpy(topw), torch.from_numpy(topi),
            torch.nn.functional.silu)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 2e-3)):
        ref = jax_moe_grouped(jnp.asarray(x), jexp, jnp.asarray(topw), jnp.asarray(topi),
                              jax.nn.silu, tm=16, backend="xla", dequant_dtype=jdt)
        reset_counts()
        got = moe_grouped_mlp(*args, compute_dtype=tdt)
        assert sum(COUNTS.values()) == 3 and all(k.endswith("_plain") for k in COUNTS)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol, atol=tol)
    fused = fuse_projections({"layers": [{"experts": texp}]}, None)["layers"][0]["experts"]
    assert set(fused) == {"gateup", "down"}
    got_f = moe_grouped_mlp(args[0], fused, *args[2:], compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got_f.numpy(), got.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kinds", [MIXED, DENSE], ids=["q4k", "dense"])
def test_fuse_projections_keeps_no_unfused_bank(kinds):
    """Fusing is in place: the model then holds the fused gate/up bank only,
    and the unfused banks are released once the caller drops them (so a
    server sizes its KV pool without a second copy of the expert banks)."""
    _, texp = _banks(kinds)
    parts = [texp[key] for key in ("gate", "up")]
    refs = [weakref.ref(p.data if isinstance(p, QTensor) else p) for p in parts]
    weights = {"layers": [{"experts": texp}]}
    del texp, parts
    assert fuse_projections(weights, None) is weights
    assert set(weights["layers"][0]["experts"]) == {"gateup", "down"}
    gc.collect()
    assert all(r() is None for r in refs)


def test_moe_grouped_mlp_refuses_expert_parallel():
    _, texp = _banks(DENSE)
    topi, topw = _routing("ragged", 4)
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        moe_grouped_mlp(torch.zeros(4, H), texp, torch.from_numpy(topw),
                        torch.from_numpy(topi), torch.nn.functional.silu, expert_offset=0)


MOE_KW = dict(vocab_size=256, hidden_size=H, intermediate_size=I, num_layers=2, num_heads=4,
              num_kv_heads=2, head_dim=64, max_position_embeddings=256, rope_theta=1e6,
              num_experts=E, num_experts_per_tok=2, moe_intermediate_size=I)


@pytest.mark.parametrize("arch", ["mixtral", "llama"])
@pytest.mark.parametrize("kinds", [MIXED, DENSE], ids=["grouped", "dense_banks"])
def test_moe_mlp_matches_jax(arch, kinds):
    """``_moe_mlp`` for both ported routers on a [2, 5, H] f32 input: the
    router logits and chosen experts are equal, then the outputs agree to
    1e-5 (grouped: bf16 weights in both; dense banks: f32 throughout)."""
    cfg_kw = dict(MOE_KW, arch=arch)
    jexp, texp = _banks(kinds, seed=8)
    rng = np.random.default_rng(9)
    router = (rng.standard_normal((E, H)) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 5, H)).astype(np.float32)
    jcfg, cfg = JaxConfig(**cfg_kw), ModelConfig(**cfg_kw)
    jl = np.asarray(jax_linear(jnp.asarray(x), jnp.asarray(router), backend="xla"))
    tl = linear(torch.from_numpy(x), torch.from_numpy(router)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    if arch == "mixtral":
        probs = jax.nn.softmax(jnp.asarray(jl), axis=-1)
        _, jtopi = jax.lax.top_k(probs, 2)
    else:
        _, jtopi = jax.lax.top_k(jnp.asarray(jl), 2)
    topw, topi = route(torch.from_numpy(tl), cfg)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    np.testing.assert_allclose(topw.sum(-1).numpy(), 1.0, rtol=1e-6)
    ref = jax_moe_mlp(jnp.asarray(x), {"router": jnp.asarray(router), "experts": jexp},
                      jcfg, jax.nn.silu, "xla")
    got = _moe_mlp(torch.from_numpy(x), {"router": torch.from_numpy(router),
                                         "experts": texp}, cfg)
    assert got.shape == (2, 5, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_routers_agree_and_sparse_combine_refused():
    """The two routers choose the same experts with the same weights. Dense
    banks of 16 experts at few tokens, where the JAX package takes its
    sparse combine, run the grouped route (the dense grouped kernel's plain
    version) and give JAX ``_moe_mlp``'s output (f32, 1e-5); hunyuan_moe's
    router (softmax over all experts with its own shared MLP) stays
    refused (qwen2moe's, ported, is held against JAX in
    ``test_torch_moe_gptq.py``)."""
    rng = np.random.default_rng(10)
    logits = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    wm, im = route(logits, ModelConfig(**dict(MOE_KW, arch="mixtral", num_experts=8)))
    wl, il = route(logits, ModelConfig(**dict(MOE_KW, arch="llama", num_experts=8)))
    assert torch.equal(im, il)
    np.testing.assert_allclose(wm.numpy(), wl.numpy(), rtol=1e-6)
    kw = dict(MOE_KW, arch="mixtral", num_experts=16)
    cfg = ModelConfig(**kw)
    banks = {k: (rng.standard_normal(shape) * 0.3).astype(np.float32)
             for k, shape in (("gate", (16, 8, 8)), ("up", (16, 8, 8)), ("down", (16, 8, 8)))}
    router = (rng.standard_normal((16, 8)) * 0.5).astype(np.float32)
    x = rng.standard_normal((1, 2, 8)).astype(np.float32)
    lw = {"router": torch.from_numpy(router),
          "experts": {k: torch.from_numpy(v) for k, v in banks.items()}}
    reset_counts()
    got = _moe_mlp(torch.from_numpy(x), lw, cfg)
    assert COUNTS["dense_matmul_g_plain"] == 3
    ref = jax_moe_mlp(jnp.asarray(x), {"router": jnp.asarray(router),
                                       "experts": {k: jnp.asarray(v) for k, v in banks.items()}},
                      JaxConfig(**kw), jax.nn.silu, "xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="hunyuan_moe"):
        init_random_weights(ModelConfig(**dict(kw, arch="hunyuan_moe")), device="cpu")


@pytest.mark.parametrize("arch,field", [("qwen2moe", {"first_k_dense": 1}), ("glm4moe", {}),
                                        ("phimoe", {}),
                                        ("mixtral", {"shared_expert_intermediate_size": 64}),
                                        ("hunyuan_moe", {})])
def test_other_moe_features_refused(arch, field):
    """What stays unported raises: the routers of hunyuan_moe, glm4moe and
    phimoe, dense first-k layers (qwen2moe's router is ported), and a shared
    expert outside qwen2moe."""
    cfg = ModelConfig(**dict(MOE_KW, arch=arch, **field))
    with pytest.raises(NotImplementedError, match="not ported"):
        init_random_weights(cfg, device="cpu")


def _jax_moe_weights(cfg_kw, kinds_per_layer, seed=11):
    """The JAX package's tiny Mixtral weights: ``init_random_weights`` for
    everything but the MLP, plus a router and [L, E, ...] banks per layer."""
    jcfg = JaxConfig(**cfg_kw)
    jw = jax_init(jcfg, seed=seed, dtype=jnp.float32, scale=0.1)
    rng = np.random.default_rng(seed)
    layers = {k: v for k, v in jw["layers"].items() if k not in ("gate", "up", "down")}
    layers["router"] = jnp.asarray(
        (rng.standard_normal((cfg_kw["num_layers"], E, H)) * 0.1).astype(np.float32))
    per_layer = [_banks(kinds, seed=seed + 1 + i)[0] for i, kinds in enumerate(kinds_per_layer)]
    layers["experts"] = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_layer)
    return jcfg, {**jw, "layers": layers}


def _assert_logits_close(tl, jl):
    assert tl.shape == jl.shape and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-2 * np.abs(jl).max())
    assert np.corrcoef(tl.ravel(), jl.ravel())[0, 1] > 0.9999


def _run_moe_both(jcfg, jw, tcfg, tw, num_blocks=17):
    """Logits of every step (f32 compute and pools) from both packages."""
    jc = JaxCache.create(jcfg, num_blocks, BS, dtype=jnp.float32)
    tc = PagedKVCache.create(tcfg, num_blocks, BS, dtype=torch.float32, device="cpu")
    bt, steps = _schedule()
    out = []
    for ids, pos, slots, kv_lens, last in steps:
        ids = ids % jcfg.vocab_size
        jl, jc = jax_forward(
            jw, jcfg, jnp.asarray(ids), jnp.asarray(pos), jc, jnp.asarray(bt),
            jnp.asarray(slots), jnp.asarray(kv_lens), block_size=BS, backend="xla",
            compute_dtype=jnp.float32,
            last_indices=None if last is None else jnp.asarray(last),
        )
        tl, tc = forward_paged(
            tw, tcfg, torch.from_numpy(ids).long(), torch.from_numpy(pos).long(), tc,
            torch.from_numpy(bt), torch.from_numpy(slots), torch.from_numpy(kv_lens),
            block_size=BS, compute_dtype=torch.float32,
            last_indices=None if last is None else torch.from_numpy(last).long(),
        )
        out.append((np.asarray(jl, np.float32), tl.numpy()))
    return out


WIDENED = {"gate": "Q4_K", "up": "Q4_K", "down": "widened"}


@pytest.mark.parametrize("kinds,fused", [(MIXED, False), (WIDENED, True)],
                         ids=["q4k_q6k", "widened_down_fused"])
def test_tiny_mixtral_from_jax_params(kinds, fused):
    """2-layer Mixtral (Q4_K gate/up; Q6_K down, or down widened to int8 /
    group 16 with a bias plane as the JAX loader stacks mixed layers)
    carried by ``from_jax_params``: logits of a chunked prefill and three
    decode steps agree with JAX ``forward_paged(backend="xla")`` (module
    docstring)."""
    cfg_kw = dict(MOE_KW, arch="mixtral")
    jcfg, jw = _jax_moe_weights(cfg_kw, [kinds, kinds])
    cfg = ModelConfig(**cfg_kw)
    tw = from_jax_params(jax_to_numpy(jw), cfg, device="cpu", dtype=torch.float32)
    down = tw["layers"][0]["experts"]["down"]
    assert down.num_banks == E and down.signed and (down.bias is not None) == (kinds is WIDENED)
    assert tw["layers"][0]["router"].shape == (E, H)
    if fused:
        tw = fuse_projections(tw, cfg)
        assert set(tw["layers"][1]["experts"]) == {"gateup", "down"}
    reset_counts()
    for jl, tl in _run_moe_both(jcfg, jw, cfg, tw):
        _assert_logits_close(tl, jl)
    per_forward = 2 if fused else 3
    assert COUNTS["w4_matmul_g_plain"] + COUNTS["w8_matmul_g_plain"] == 4 * 2 * per_forward


def _write_mixtral_gguf(path, kw, down_types, seed=12):
    """A tiny GGUF as llama.cpp writes Mixtral: arch llama with expert
    metadata, ``ffn_*_exps`` banks ([E, out, in]), an F32 router, Q4_K
    attention and gate/up banks, per-layer down types, Q8_0 embedding and
    head."""
    rng = np.random.default_rng(seed)
    h, mi, v, nl = kw["hidden_size"], kw["moe_intermediate_size"], kw["vocab_size"], kw["num_layers"]
    qd, kvd = kw["num_heads"] * kw["head_dim"], kw["num_kv_heads"] * kw["head_dim"]
    w = GGUFWriter(path)
    a = "llama"
    for key, val in (("block_count", nl), ("context_length", kw["max_position_embeddings"]),
                     ("embedding_length", h), ("feed_forward_length", mi),
                     ("attention.head_count", kw["num_heads"]),
                     ("attention.head_count_kv", kw["num_kv_heads"]),
                     ("vocab_size", v), ("expert_count", E), ("expert_used_count", 2)):
        w.add_metadata(f"{a}.{key}", np.uint32(val))
    w.add_metadata("general.architecture", a)
    w.add_metadata(f"{a}.attention.layer_norm_rms_epsilon", np.float32(1e-5))
    w.add_metadata(f"{a}.rope.freq_base", np.float32(kw["rope_theta"]))

    def r(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    w.add_tensor("token_embd.weight", r(v, h), JaxType.Q8_0)
    w.add_tensor("output_norm.weight", 1 + r(h))
    w.add_tensor("output.weight", r(v, h), JaxType.Q8_0)
    for i in range(nl):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", 1 + r(h))
        w.add_tensor(p + "ffn_norm.weight", 1 + r(h))
        for name, shape in (("attn_q", (qd, h)), ("attn_k", (kvd, h)), ("attn_v", (kvd, h)),
                            ("attn_output", (h, qd))):
            w.add_tensor(p + name + ".weight", r(*shape), JaxType.Q4_K)
        w.add_tensor(p + "ffn_gate_inp.weight", r(E, h, s=0.1))
        w.add_tensor(p + "ffn_gate_exps.weight", r(E, mi, h), JaxType.Q4_K)
        w.add_tensor(p + "ffn_up_exps.weight", r(E, mi, h), JaxType.Q4_K)
        w.add_tensor(p + "ffn_down_exps.weight", r(E, h, mi), JaxType[down_types[i]])
    w.write()


@pytest.mark.parametrize("down_types", [("Q6_K", "Q4_K"), ("F16", "F16")],
                         ids=["q6k_q4k_down", "f16_down"])
def test_tiny_mixtral_gguf_both_loaders(tmp_path, monkeypatch, down_types):
    """A tiny Mixtral GGUF loads through each package's loader; the port
    keeps each layer's own down type, and the logits agree (module
    docstring). The JAX loader stacks the per-layer banks
    with ``tree_map``, which refuses banks of different types, so for the
    mixed file each split expert is widened first (int8, group 16, bias: an
    exact re-expression, what ``_stack_weights`` does to a mixed stack)."""
    path = str(tmp_path / "tiny-mixtral.gguf")
    kw = dict(MOE_KW, arch="llama")
    _write_mixtral_gguf(path, kw, down_types)
    if len(set(down_types)) > 1:
        split = jax_loader._split_experts
        monkeypatch.setattr(jax_loader, "_split_experts", lambda t: [
            jax_loader._Tensor(None, widen_planar(p.planar), p.shape, None)
            if p.planar is not None else p for p in split(t)])
    jcfg, jw, _ = jax_load_gguf(path)
    tcfg, tw, _ = load_gguf_model(path, device="cpu")
    assert (tcfg.num_experts, tcfg.num_experts_per_tok, tcfg.arch) == (E, 2, "llama")
    downs = [lw["experts"]["down"] for lw in tw["layers"]]
    if down_types[0] == "F16":
        assert all(isinstance(d, torch.Tensor) and d.shape == (E, H, I) for d in downs)
        assert isinstance(tw["layers"][0]["experts"]["gate"], QTensor)
    else:
        assert downs[0].ggml_type == GGMLType.Q6_K and downs[0].group_size == 16
        assert downs[1].packed and downs[1].num_banks == E
    if len(set(down_types)) == 1:  # same planes in both packages
        gate = tw["layers"][1]["experts"]["gate"]
        np.testing.assert_array_equal(gate.data.numpy(),
                                      np.asarray(jw["layers"]["experts"]["gate"].data[1]))
    reset_counts()
    for jl, tl in _run_moe_both(jcfg, jw, tcfg, tw):
        _assert_logits_close(tl, jl)
    assert COUNTS["w4_matmul_g_plain"] > 0
    dense_down = down_types[0] == "F16"
    assert (COUNTS["dense_matmul_g_plain"] > 0) == dense_down
    assert (COUNTS["w8_matmul_g_plain"] > 0) == (not dense_down)


def test_init_random_weights_moe_shares_jax_numbers():
    """The port's init draws in the JAX function's order: the shared leaves
    are equal; an MoE config then adds a router and banks in place of the
    dense MLP."""
    cfg_kw = dict(MOE_KW, arch="mixtral", num_layers=1, vocab_size=64)
    jw = jax_init(JaxConfig(**cfg_kw), seed=3, dtype=jnp.float32)
    tw = init_random_weights(ModelConfig(**cfg_kw), seed=3, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tw["embed"].numpy(), np.asarray(jw["embed"]))
    np.testing.assert_array_equal(tw["lm_head"].numpy(), np.asarray(jw["lm_head"]))
    np.testing.assert_array_equal(tw["layers"][0]["wo"].numpy(), np.asarray(jw["layers"]["wo"][0]))
    lw = tw["layers"][0]
    assert "gate" not in lw and lw["router"].shape == (E, H)
    assert lw["experts"]["down"].shape == (E, H, I)
    assert lw["experts"]["gate"].device.type == "cpu"
