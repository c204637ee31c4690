"""UQFF files, the GGUF writer and the ``quantize``/``uqff-inspect``
commands of the port, held against the JAX package on the CPU with inputs
drawn with numpy from a seed.

* ``uqff_tpu`` files: the tiny llama of ``test_torch_isq.py`` quantized in
  situ to Q4_K, and with HQQ-4 (group 64) and blockwise FP8 (128 x 128)
  projections, saved by the port and loaded by JAX ``load_uqff``, then saved
  by JAX ``save_uqff`` and loaded by the port: every plane, code and scale
  equal in both directions (the port's weights carried across by
  ``from_jax_params``); the JAX model over the port's file and the port's
  ``load_pipeline`` of JAX's file give f32 logits within 1e-2 of the
  largest (a prefill chunk and a decode step); a file whose layers mix
  formats is refused by name.
* mistral.rs UQFF v1.x: ``save_reference_uqff`` writes the JAX package's
  bytes, for one type and for a per-tensor map (Q2_K, Q3_K, Q8_0, None);
  ``load_reference_uqff`` of a JAX-written file gives JAX's planes;
  ``load_hf_model(from_uqff=)`` weights equal JAX's carried across, logits
  within 1e-2; the refusals JAX makes (serde type 2, major version 2) with
  the same messages; such a file as the model path is refused by name.
* The GGUF writer and ``convert_hf_to_gguf`` (Q4_K with an imatrix, the
  tokenizer's metadata): the JAX package's bytes. ``cli quantize`` to
  ``.gguf`` and ``.uqff`` (the same bytes again), ``cli uqff-inspect``, and
  ``cli serve`` of a ``.uqff`` file and with ``--from-uqff`` (in-process,
  the server stopped before it serves).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mistralrs_tpu.convert import convert_hf_to_gguf as jax_convert
from mistralrs_tpu.convert import tokenizer_metadata_from_hf as jax_tok_md
from mistralrs_tpu.gguf.constants import GGMLType as JaxType
from mistralrs_tpu.gguf.writer import GGUFWriter as JaxWriter
from mistralrs_tpu.models.config import ModelConfig as JaxConfig
from mistralrs_tpu.models.hf_loader import load_hf_model as jax_load_hf
from mistralrs_tpu.uqff import load_reference_uqff as jax_load_ref
from mistralrs_tpu.uqff import load_uqff as jax_load_uqff
from mistralrs_tpu.uqff import save_reference_uqff as jax_save_ref
from mistralrs_tpu.uqff import save_uqff as jax_save_uqff
from mistralrs_tpu_torch import cli
from mistralrs_tpu_torch.convert import (
    convert_hf_to_gguf,
    from_jax_params,
    tokenizer_metadata_from_hf,
)
from mistralrs_tpu_torch.gguf.constants import GGMLType
from mistralrs_tpu_torch.gguf.writer import GGUFWriter
from mistralrs_tpu_torch.models.config import ModelConfig, config_from_hf
from mistralrs_tpu_torch.models.hf_loader import load_hf_model, weights_from_state_dict
from mistralrs_tpu_torch.pipeline import load_pipeline
from mistralrs_tpu_torch.quant.fp8 import Fp8Tensor
from mistralrs_tpu_torch.quant.hqq import hqq_quantize
from mistralrs_tpu_torch.quant.qtensor import QTensor
from mistralrs_tpu_torch.serving.server import Server
from mistralrs_tpu_torch.uqff import (
    is_reference_uqff,
    load_reference_uqff,
    load_uqff,
    save_reference_uqff,
    save_uqff,
)

from test_torch_gptq_awq import _weights_equal
from test_torch_isq import _case, _write_dir
from test_torch_llama import jax_to_numpy
from test_torch_quant_formats import logits_match

PROJ = ("wq", "wk", "wv", "wo", "gate", "up", "down")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small torch ops (the quantizers, HQQ's solver): one thread, as
    in ``test_torch_isq.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tree(w):
    """A JAX weight tree with FP8 leaves as plane dicts (``jax_to_numpy``
    knows QTensors only)."""
    from mistralrs_tpu.quant.fp8 import Fp8Tensor as JaxFp8

    if isinstance(w, JaxFp8):
        return {"data": np.asarray(w.data), "scale": np.asarray(w.scale),
                "block_shape": w.block_shape}
    if isinstance(w, dict):
        return {k: _jax_tree(v) for k, v in w.items()}
    return jax_to_numpy(w)


def _fp8_equal(a, b):
    if isinstance(a, dict):
        for k in a:
            _fp8_equal(a[k], b[k])
    elif isinstance(a, list):
        for x, y in zip(a, b):
            _fp8_equal(x, y)
    elif isinstance(a, Fp8Tensor):
        assert a.block_shape == b.block_shape
        assert torch.equal(a.data.view(torch.uint8), b.data.view(torch.uint8))
        assert torch.equal(a.scale, b.scale)
    else:
        _weights_equal(a, b)


def _port_weights(kind):
    """(HF config, port config, weights) of the tiny llama: ``q4k`` (ISQ),
    ``hqq`` (projections HQQ-4 at group 64) or ``fp8`` (blockwise 128 x 128
    projections); dense leaves f32."""
    hf_cfg, sd, _ = _case("llama_q4k_imatrix", seed=11)
    cfg = config_from_hf(hf_cfg)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    tw = weights_from_state_dict(tsd, cfg, dtype=torch.float32, device="cpu",
                                 isq=GGMLType.Q4_K if kind == "q4k" else None)
    if kind in ("hqq", "fp8"):
        for lw in tw["layers"]:
            for key in PROJ:
                w = lw[key]
                lw[key] = (hqq_quantize(w, 4, 64, device="cpu") if kind == "hqq"
                           else Fp8Tensor.quantize(w, (128, 128), device="cpu"))
    return hf_cfg, cfg, tw


@pytest.mark.parametrize("kind", ["q4k", "hqq", "fp8"])
def test_uqff_tpu_both_directions(tmp_path, kind):
    hf_cfg, cfg, tw = _port_weights(kind)
    save_uqff(str(tmp_path / "port.uqff"), cfg, tw)
    jcfg, jw = jax_load_uqff(str(tmp_path / "port.uqff"))
    assert (jcfg.arch, jcfg.num_layers, jcfg.hidden_size) == ("llama", 2, 256)
    _fp8_equal(tw, from_jax_params(_jax_tree(jw), cfg, device="cpu", dtype=torch.float32))
    jax_save_uqff(str(tmp_path / "jax.uqff"), jcfg, jw)
    pipe = load_pipeline(str(tmp_path / "jax.uqff"), dtype=torch.float32, device="cpu")
    assert pipe.cfg == cfg and pipe.model_id == "jax" and pipe.tokenizer is None
    _fp8_equal(tw, pipe.weights)
    logits_match(jcfg, jw, pipe.cfg, pipe.weights)


def test_uqff_tpu_refuses_mixed_layers(tmp_path):
    _, cfg, tw = _port_weights("q4k")
    tw["layers"][1]["wq"] = tw["layers"][1]["wq"].dequantize()
    with pytest.raises(NotImplementedError, match="layers.wq"):
        save_uqff(str(tmp_path / "x.uqff"), cfg, tw)


def _ref_sd(seed=12):
    hf_cfg, sd, _ = _case("llama_q4k_imatrix", seed=seed)
    return hf_cfg, {k: v.astype(np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("quant", ["q4k", "map"])
def test_reference_uqff_bytes_equal_jax(tmp_path, quant):
    _, sd = _ref_sd()
    if quant == "q4k":
        jq, tq = JaxType.Q4_K, GGMLType.Q4_K
    else:
        names = sorted(n for n in sd if n.endswith("_proj.weight"))
        types = [None, "Q2_K", "Q3_K", "Q8_0"]
        jq = {n: None if types[i % 4] is None else JaxType[types[i % 4]]
              for i, n in enumerate(names)}
        tq = {n: None if t is None else GGMLType[t.name] for n, t in jq.items()}
    jax_save_ref(str(tmp_path / "j.uqff"), sd, jq)
    save_reference_uqff(str(tmp_path / "p.uqff"), {k: torch.from_numpy(v) for k, v in sd.items()},
                        tq)
    assert (tmp_path / "p.uqff").read_bytes() == (tmp_path / "j.uqff").read_bytes()
    assert is_reference_uqff(str(tmp_path / "p.uqff"))
    want = jax_load_ref(str(tmp_path / "j.uqff"))
    got = load_reference_uqff(str(tmp_path / "j.uqff"), device="cpu")
    assert set(got) == set(want)
    for name, w in want.items():
        if isinstance(got[name], QTensor):
            planes = jax_to_numpy(w)
            _weights_equal(got[name], QTensor(
                torch.from_numpy(planes["data"].copy()), torch.from_numpy(planes["scale"].copy()),
                None if planes["bias"] is None else torch.from_numpy(planes["bias"].copy()),
                w.group_size, w.packed, w.code_bits))
        else:
            assert np.array_equal(got[name].numpy(), np.asarray(w)), name


def _overlay_dir(tmp_path):
    """A tiny llama directory (f16, a tokenizer) and a mistral.rs UQFF file
    of its projections at Q4_K, written by the JAX package."""
    hf_cfg, sd, _ = _write_dir(tmp_path / "m", "llama_q4k_imatrix", seed=13, tokenizer=True)
    proj = {n: v.astype(np.float32) for n, v in sd.items() if n.endswith("_proj.weight")}
    jax_save_ref(str(tmp_path / "o.uqff"), proj, JaxType.Q4_K)
    return hf_cfg


def test_from_uqff_overlay_matches_jax(tmp_path):
    _overlay_dir(tmp_path)
    jcfg, jw, _ = jax_load_hf(tmp_path / "m", dtype=jnp.float32,
                              from_uqff=str(tmp_path / "o.uqff"))
    cfg, tw, _ = load_hf_model(tmp_path / "m", dtype=torch.float32, device="cpu",
                               from_uqff=str(tmp_path / "o.uqff"))
    assert isinstance(tw["layers"][0]["wq"], QTensor) and tw["layers"][0]["wq"].packed
    assert isinstance(tw["embed"], torch.Tensor)
    _weights_equal(tw, from_jax_params(jax_to_numpy(jw), cfg, device="cpu",
                                       dtype=torch.float32))
    logits_match(jcfg, jw, cfg, tw)


def test_reference_uqff_refusals(tmp_path):
    from mistralrs_tpu_torch.models.hf_loader import write_safetensors as port_write

    base = {"uqff.version.major": torch.tensor([1], dtype=torch.uint32),
            "uqff.version.minor": torch.tensor([2], dtype=torch.uint32),
            "uqff.version.patch": torch.tensor([0], dtype=torch.uint32),
            "a.weight.format": torch.tensor([2], dtype=torch.uint8),
            "a.weight": torch.zeros(4, dtype=torch.uint8)}
    cases = {"serde": base, "major": dict(base, **{
        "uqff.version.major": torch.tensor([2], dtype=torch.uint32)})}
    for name, tensors in cases.items():
        f = str(tmp_path / f"{name}.uqff")
        port_write(f, tensors)
        with pytest.raises(ValueError) as port_err:
            load_reference_uqff(f, device="cpu")
        with pytest.raises(ValueError) as jax_err:
            jax_load_ref(f)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="mistral.rs UQFF"):
        load_pipeline(str(tmp_path / "serde.uqff"), device="cpu")


def test_gguf_writer_and_converter_bytes_equal_jax(tmp_path):
    """Metadata of every kind and F32/F16/BF16/Q8_0/Q4_K tensors through
    both writers; then ``convert_hf_to_gguf`` at Q4_K with an imatrix and
    tokenizer metadata, and ``cli quantize`` to ``.gguf``."""
    rng = np.random.default_rng(14)
    a = rng.standard_normal((16, 256)).astype(np.float32)
    for name, w in (("j", JaxWriter(str(tmp_path / "j.gguf"))),
                    ("p", GGUFWriter(str(tmp_path / "p.gguf")))):
        w.add_metadata("general.architecture", "llama")
        w.add_metadata("u32", np.uint32(7))
        w.add_metadata("f32", np.float32(0.5))
        w.add_metadata("flag", True)
        w.add_metadata("neg", -3)
        w.add_metadata("toks", ["a", "b"])
        w.add_metadata("ids", [1, 2, 3])
        for t in ("F32", "F16", "BF16", "Q8_0", "Q4_K"):
            data = a if name == "j" else torch.from_numpy(a)
            w.add_tensor(f"t.{t}", data, (JaxType if name == "j" else GGMLType)[t])
        w.write()
    assert (tmp_path / "p.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()

    tokenizers = pytest.importorskip("tokenizers")
    tok = tokenizers.Tokenizer(tokenizers.models.BPE({"a": 0, "b": 1, "ab": 2}, [("a", "b")]))
    assert tokenizer_metadata_from_hf(tok) == jax_tok_md(tok)
    hf_cfg, sd = _ref_sd(seed=15)
    kw = dict(arch="llama", vocab_size=128, hidden_size=256, intermediate_size=512,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
              max_position_embeddings=128, rope_theta=1e4, bos_token_id=1, eos_token_ids=(2,))
    im = {tap: (rng.random((2, k)) + 0.01).astype(np.float32)
          for tap, k in (("attn_in", 256), ("mlp_in", 256), ("down_in", 512), ("o_in", 256))}
    jax_convert(sd, JaxConfig(**kw), str(tmp_path / "jc.gguf"), quant=JaxType.Q4_K,
                tokenizer_metadata=jax_tok_md(tok), imatrix=im)
    convert_hf_to_gguf({k: torch.from_numpy(v) for k, v in sd.items()}, ModelConfig(**kw),
                       str(tmp_path / "pc.gguf"), quant=GGMLType.Q4_K,
                       tokenizer_metadata=tokenizer_metadata_from_hf(tok), imatrix=im,
                       device="cpu")
    assert (tmp_path / "pc.gguf").read_bytes() == (tmp_path / "jc.gguf").read_bytes()


def test_cli_quantize_inspect_and_serve(tmp_path, monkeypatch, capsys):
    """``cli quantize`` to ``.gguf`` (JAX ``cmd_quantize``'s bytes) and to
    ``.uqff`` (``save_reference_uqff``'s); ``uqff-inspect`` of both UQFF
    kinds; ``cli serve`` of a ``.uqff`` file with a tokenizer beside it and
    of a directory with ``--from-uqff``."""
    from mistralrs_tpu import cli as jax_cli

    _overlay_dir(tmp_path)
    m = str(tmp_path / "m")
    for ext in ("gguf", "uqff"):
        assert jax_cli.main(["quantize", m, "--quant", "q5_0", "-o",
                             str(tmp_path / f"j.{ext}")]) == 0
        assert cli.main(["quantize", m, "--quant", "q5_0", "-o", str(tmp_path / f"p.{ext}"),
                         "--device", "cpu"]) == 0
        assert (tmp_path / f"p.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    capsys.readouterr()
    assert cli.main(["uqff-inspect", str(tmp_path / "p.uqff")]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert ref["format"] == "mistral.rs-uqff" and ref["tensor_count"] > 0
    cfg, tw, _ = load_hf_model(m, dtype=torch.float32, device="cpu")
    (tmp_path / "s").mkdir()
    save_uqff(str(tmp_path / "s" / "model.uqff"), cfg, tw)
    (tmp_path / "s" / "tokenizer.json").write_bytes((tmp_path / "m" / "tokenizer.json")
                                                     .read_bytes())
    assert cli.main(["uqff-inspect", str(tmp_path / "s" / "model.uqff")]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert ours["format"] == "mistralrs_tpu-uqff" and "uqff_tpu" in ours["metadata"]
    seen = []

    def stop(self):
        seen.append(self.resolve(None).engine.weights)
        self.shutdown()
        raise KeyboardInterrupt

    monkeypatch.setattr(Server, "serve_forever", stop)
    args = ["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--max-seq-len", "64"]
    assert cli.main(["serve", str(tmp_path / "s" / "model.uqff"), *args]) == 0
    assert cli.main(["serve", m, "--from-uqff", str(tmp_path / "o.uqff"), *args]) == 0
    assert isinstance(seen[1]["layers"][0]["wqkv"], QTensor)
    assert not isinstance(seen[0]["layers"][0].get("wqkv"), QTensor)


def test_load_uqff_of_a_reference_file_is_refused(tmp_path):
    _, sd = _ref_sd()
    save_reference_uqff(str(tmp_path / "r.uqff"), {k: torch.from_numpy(v) for k, v in sd.items()},
                        GGMLType.Q8_0)
    with pytest.raises(ValueError, match="mistral.rs UQFF"):
        load_uqff(str(tmp_path / "r.uqff"), device="cpu")
