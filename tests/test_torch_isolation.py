"""The port stands alone: importing every module of mistralrs_tpu_torch
loads neither jax nor any module of the JAX package; its entry points refuse
to run without a card unless the caller asks for the CPU; and a kernel
wrapper without a CUDA build raises instead of falling back."""

import dataclasses
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import mistralrs_tpu_torch
from mistralrs_tpu_torch import resolve_device
from mistralrs_tpu_torch.convert import (
    convert_hf_to_gguf,
    from_jax_deepseek_params,
    from_jax_params,
)
from mistralrs_tpu_torch.engine.adapters import DeepseekAdapter
from mistralrs_tpu_torch.embeddings import embed
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.generate import generate
from mistralrs_tpu_torch.gguf.constants import GGMLType
from mistralrs_tpu_torch.gguf.planar import PlanarQuant
from mistralrs_tpu_torch.imatrix import ImatrixCollector
from mistralrs_tpu_torch.kv.contiguous import HybridKVCache, KVCache, RotatingKVCache
from mistralrs_tpu_torch.kv.paged import PagedKVCache
from mistralrs_tpu_torch.models import ModelConfig, init_random_weights
from mistralrs_tpu_torch.models import deepseek
from mistralrs_tpu_torch.models.gguf_loader import load_gguf_model
from mistralrs_tpu_torch.ops import _cuda
from mistralrs_tpu_torch.ops.mla_attention import _mla_cuda
from mistralrs_tpu_torch.ops.paged_attention import _decode_cuda
from mistralrs_tpu_torch.ops.quant_matmul import quant_matmul
from mistralrs_tpu_torch.perplexity import compute_perplexity
from mistralrs_tpu_torch.pipeline import load_pipeline
from mistralrs_tpu_torch.quant.bnb import dequantize_4bit
from mistralrs_tpu_torch.quant.fp8 import Fp8Tensor
from mistralrs_tpu_torch.quant.hqq import hqq_from_state, hqq_quantize
from mistralrs_tpu_torch.quant.qtensor import QTensor
from mistralrs_tpu_torch.uqff import load_reference_uqff, load_uqff

REPO = Path(__file__).resolve().parent.parent
CFG = ModelConfig(arch="llama", vocab_size=64, hidden_size=32, intermediate_size=64,
                  num_layers=1, num_heads=2, num_kv_heads=1, head_dim=16)
SLIDING = dataclasses.replace(CFG, sliding_window=8)
GEMMA2 = dataclasses.replace(CFG, arch="gemma2", num_layers=2, sliding_window=8)


def test_imports_no_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        mistralrs_tpu_torch.__path__, "mistralrs_tpu_torch."))
    assert len(modules) >= 25
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {modules!r}:
            importlib.import_module(name)
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "mistralrs_tpu" or m.startswith("mistralrs_tpu.")]
        assert not bad, bad
        print("ok", len({modules!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_refuse_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = init_random_weights(CFG, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(CFG, w, num_blocks=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_pipeline(str(tmp_path / "missing.gguf"))
    assert resolve_device("cpu").type == "cpu"
    Engine(CFG, w, num_blocks=4, device="cpu")  # explicit CPU is fine


def _cpu_numpy_params():
    """The JAX package's weight layout, as numpy, for ``from_jax_params``."""
    w = init_random_weights(CFG, device="cpu", dtype=torch.float32)
    stacked = {k: torch.stack([lw[k] for lw in w["layers"]]).numpy() for k in w["layers"][0]}
    return {"embed": w["embed"].numpy(), "layers": stacked,
            "final_norm": w["final_norm"].numpy(), "lm_head": w["lm_head"].numpy()}


DS_CFG = deepseek.DeepseekConfig(
    vocab_size=32, hidden_size=16, intermediate_size=32, moe_intermediate_size=16,
    num_layers=2, num_heads=2, q_lora_rank=None, kv_lora_rank=16, qk_rope_head_dim=8,
    qk_nope_head_dim=8, v_head_dim=8, n_routed_experts=2, num_experts_per_tok=1,
    n_shared_experts=1, first_k_dense_replace=1)


def _jax_deepseek_numpy():
    """The JAX package's DeepSeek weight layout (stacked dense and moe
    segments), as numpy, for ``from_jax_deepseek_params``."""
    w = deepseek.init_random_weights(DS_CFG, device="cpu", dtype=torch.float32)

    def stack(lws):
        out = {}
        for k, v in lws[0].items():
            if isinstance(v, dict):
                out[k] = {kk: torch.stack([lw[k][kk] for lw in lws]).numpy() for kk in v}
            else:
                out[k] = torch.stack([lw[k] for lw in lws]).numpy()
        if "experts" in out:
            gu = out["experts"].pop("gateup")
            out["experts"]["gate"], out["experts"]["up"] = np.split(gu, 2, axis=2)
        return out

    return {"embed": w["embed"].numpy(), "final_norm": w["final_norm"].numpy(),
            "lm_head": w["lm_head"].numpy(),
            "segments": {"dense": stack(w["layers"][:1]), "moe": stack(w["layers"][1:])}}


_PLANAR = PlanarQuant(np.zeros(64 * 32, np.int8), np.ones(64 * 32 // 32, np.float32), None,
                      32, 8, True)
# every public constructor, called without ``device``; each refuses to place
# its tensors anywhere but a card, and on the CPU only when asked
CONSTRUCTORS = {
    "init_random_weights": lambda tmp: init_random_weights(CFG),
    "from_jax_params": lambda tmp: from_jax_params(_cpu_numpy_params(), CFG),
    "PagedKVCache.create": lambda tmp: PagedKVCache.create(CFG, 4, 16),
    "QTensor.from_planar": lambda tmp: QTensor.from_planar(_PLANAR, (64, 32)),
    "QTensor.from_gguf_raw": lambda tmp: QTensor.from_gguf_raw(
        np.zeros(64 * 34, np.uint8), GGMLType.Q8_0, (64, 32)),
    "load_gguf_model": lambda tmp: load_gguf_model(str(tmp / "missing.gguf")),
    "deepseek.init_random_weights": lambda tmp: deepseek.init_random_weights(DS_CFG),
    "deepseek.make_paged_cache": lambda tmp: deepseek.make_paged_cache(DS_CFG, 4, 16),
    "DeepseekAdapter": lambda tmp: DeepseekAdapter(
        DS_CFG, deepseek.init_random_weights(DS_CFG, device="cpu")),
    "from_jax_deepseek_params": lambda tmp: from_jax_deepseek_params(
        _jax_deepseek_numpy(), DS_CFG),
    "KVCache.create": lambda tmp: KVCache.create(CFG, 1, 8),
    "RotatingKVCache.create": lambda tmp: RotatingKVCache.create(SLIDING, 1),
    "HybridKVCache.create": lambda tmp: HybridKVCache.create(GEMMA2, 1, 16),
    "ImatrixCollector": lambda tmp: ImatrixCollector(CFG),
    # the library entry points over the contiguous cache, given CPU weights
    "generate": lambda tmp: generate(init_random_weights(CFG, device="cpu"), CFG, [1, 2]),
    "compute_perplexity": lambda tmp: compute_perplexity(
        init_random_weights(CFG, device="cpu"), CFG, list(range(32)), window=16),
    "embed": lambda tmp: embed(init_random_weights(CFG, device="cpu"), CFG, [[1, 2]]),
    # the weight formats: FP8, HQQ, bitsandbytes, UQFF files, the GGUF converter
    "Fp8Tensor.quantize": lambda tmp: Fp8Tensor.quantize(torch.ones(16, 128)),
    "hqq_quantize": lambda tmp: hqq_quantize(torch.ones(16, 128)),
    "hqq_from_state": lambda tmp: hqq_from_state(
        np.zeros(16 * 128, np.uint8), np.ones(32, np.float32), np.zeros(32, np.float32),
        (16, 128)),
    "bnb.dequantize_4bit": lambda tmp: dequantize_4bit(
        np.zeros((32, 1), np.uint8), np.ones(1, np.float32), np.zeros(16, np.float32), (64,)),
    "load_uqff": lambda tmp: load_uqff(str(tmp / "missing.uqff")),
    "load_reference_uqff": lambda tmp: load_reference_uqff(str(tmp / "missing.uqff")),
    "convert_hf_to_gguf": lambda tmp: convert_hf_to_gguf({}, CFG, str(tmp / "x.gguf")),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_default_to_the_card(monkeypatch, tmp_path, name):
    """Called without ``device``, each public constructor raises on a
    machine without a CUDA device (it does not fall back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CONSTRUCTORS[name](tmp_path)


def test_constructors_take_the_cpu_when_asked():
    qt = QTensor.from_planar(_PLANAR, (64, 32), device="cpu")
    cache = PagedKVCache.create(CFG, 4, 16, device="cpu")
    w = from_jax_params(_cpu_numpy_params(), CFG, device="cpu")
    assert qt.device.type == cache.k.device.type == w["embed"].device.type == "cpu"
    dw = from_jax_deepseek_params(_jax_deepseek_numpy(), DS_CFG, device="cpu")
    ad = DeepseekAdapter(DS_CFG, dw, device="cpu")
    pool = ad.create_cache(4, 16, 2).pool  # the cache's latent pool (LatentCache)
    assert pool.device.type == dw["layers"][1]["experts"]["gateup"].device.type == "cpu"
    assert tuple(pool.shape) == (2, 5 * 16, 24)
    caches = (KVCache.create(CFG, 1, 8, device="cpu"),
              RotatingKVCache.create(SLIDING, 1, device="cpu"),
              HybridKVCache.create(GEMMA2, 1, 16, device="cpu"))
    assert {t.device.type for c in caches for t in vars(c).values()
            if isinstance(t, torch.Tensor)} == {"cpu"}
    w = init_random_weights(CFG, device="cpu")
    assert len(generate(w, CFG, [1, 2], max_new_tokens=2, stop_tokens=set(),
                        device="cpu")) == 2
    assert embed(w, CFG, [[1, 2]], device="cpu").shape == (1, CFG.hidden_size)
    with pytest.raises(ValueError, match="weights are on meta, not on cpu"):
        embed({**w, "embed": w["embed"].to("meta")}, CFG, [[1, 2]], device="cpu")


def test_kernel_wrappers_raise_without_cuda_build(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_cuda, "_lib", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        _cuda.library()
    # the CUDA path of a wrapper validates, then needs the library: it raises
    # and never substitutes the plain version
    b, n_q, n_kv, hd = 1, 4, 1, 128
    q = torch.zeros((b, n_q, hd), dtype=torch.bfloat16)
    pool = torch.zeros((n_kv, 32, hd), dtype=torch.bfloat16)
    new = torch.zeros((b, n_kv, hd), dtype=torch.bfloat16)
    i1 = torch.zeros(b, dtype=torch.int32)
    _cuda.reset_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        _decode_cuda(q, pool, pool, new, new, i1, i1[:, None], i1, 16, 0.1)
    lat_pool = torch.zeros((32, 144), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA"):
        _mla_cuda(torch.zeros((b, 4, 144), dtype=torch.bfloat16), lat_pool,
                  torch.zeros((b, 144), dtype=torch.bfloat16), i1, i1[:, None], i1, 16, 128, 0.1)
    assert sum(_cuda.COUNTS.values()) == 0
    # a tensor on neither the CPU nor a card is refused, not computed
    qt = QTensor(torch.zeros((64, 16), dtype=torch.uint8), torch.ones((4, 16)),
                 torch.zeros((4, 16)), group_size=32, packed=True, code_bits=4)
    with pytest.raises(ValueError, match="unsupported device"):
        quant_matmul(torch.zeros((2, 128), device="meta"), qt)


# the modules of constrained decoding and the text routes, by name
SERVING_MODULES = ("mistralrs_tpu_torch.grammar", "mistralrs_tpu_torch.cfg_grammar",
                   "mistralrs_tpu_torch.tools", "mistralrs_tpu_torch.tools.parsers",
                   "mistralrs_tpu_torch.tools.reasoning", "mistralrs_tpu_torch.serving.protocol",
                   "mistralrs_tpu_torch.serving.registry", "mistralrs_tpu_torch.serving.server")


def test_serving_modules_import_no_jax(monkeypatch, tmp_path):
    """The grammar, tool and serving modules load neither jax nor the JAX
    package; a registry with no device loads its models onto the card, so it
    refuses without one."""
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {SERVING_MODULES!r}:
            importlib.import_module(name)
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "mistralrs_tpu" or m.startswith("mistralrs_tpu.")]
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    from mistralrs_tpu_torch.serving.registry import ModelRegistry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRegistry().load("m", str(tmp_path / "missing.gguf"))
