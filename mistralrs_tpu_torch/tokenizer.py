"""Tokenizer resolution + incremental detokenization (a copy of
``mistralrs_tpu/tokenizer.py``).

The ``tokenizers`` package is imported only inside the function that builds
a tokenizer, so the module imports without it.

The port reads tokenizers from GGUF metadata (the analog of the
reference's `mistralrs-core/src/gguf/gguf_tokenizer.rs`): a Unigram
(llama/spm) or byte-level BPE (gpt2) tokenizer built from the
`tokenizer.ggml.*` keys, and from a HF directory's `tokenizer.json`
(:func:`from_hf_dir`).

Also provides the incremental streaming detokenizer (the analog of the
reference's delta-decode in `Sequence`), which withholds bytes that may be a
partial UTF-8 sequence / partial token.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence


class Detokenizer:
    """Incremental decode: emits stable text deltas as token ids arrive."""

    def __init__(self, tokenizer: "TokenizerWrapper"):
        self.tok = tokenizer
        self.ids: list[int] = []
        self.prefix_text = ""
        self.stable_len = 0

    def push(self, new_ids: Sequence[int]) -> str:
        self.ids.extend(new_ids)
        text = self.tok.decode(self.ids)
        # withhold a potentially-incomplete suffix (replacement char at end)
        if text.endswith("�"):
            stable = text[: text.rfind("�")]
        else:
            stable = text
        delta = stable[self.stable_len :]
        self.stable_len = len(stable)
        return delta

    def flush(self) -> str:
        text = self.tok.decode(self.ids)
        delta = text[self.stable_len :]
        self.stable_len = len(text)
        return delta


class TokenizerWrapper:
    """Thin uniform interface over a `tokenizers.Tokenizer`."""

    def __init__(self, hf_tokenizer, bos_id=None, eos_ids=(), add_bos=True):
        self._tok = hf_tokenizer
        self.bos_id = bos_id
        self.eos_ids = tuple(eos_ids)
        self.add_bos = add_bos

    def encode(self, text: str, add_bos: Optional[bool] = None) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        use_bos = self.add_bos if add_bos is None else add_bos
        if use_bos and self.bos_id is not None and (not ids or ids[0] != self.bos_id):
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)

    def id_to_token(self, i: int) -> Optional[str]:
        return self._tok.id_to_token(i)

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def detokenizer(self) -> Detokenizer:
        return Detokenizer(self)


def from_file(path: str | Path, bos_id=None, eos_ids=()) -> TokenizerWrapper:
    """A ``tokenizer.json`` alone (no BOS unless ``bos_id`` is given), as
    JAX ``tokenizer.py::from_file`` reads it."""
    from tokenizers import Tokenizer

    return TokenizerWrapper(Tokenizer.from_file(str(path)), bos_id=bos_id, eos_ids=eos_ids)


def from_hf_dir(path: str | Path) -> TokenizerWrapper:
    """The tokenizer of a HF model directory (``tokenizer.json``; BOS and EOS
    ids from ``config.json``). Raises ``FileNotFoundError`` without
    ``tokenizer.json``."""
    path = Path(path)
    bos_id = None
    eos_ids: tuple[int, ...] = ()
    cfg_path = path / "config.json"
    if cfg_path.exists():
        cfg = json.loads(cfg_path.read_text())
        bos_id = cfg.get("bos_token_id")
        eos = cfg.get("eos_token_id")
        if isinstance(eos, int):
            eos_ids = (eos,)
        elif isinstance(eos, list):
            eos_ids = tuple(eos)
    tok_path = path / "tokenizer.json"
    if not tok_path.exists():
        raise FileNotFoundError(tok_path)
    return from_file(tok_path, bos_id=bos_id, eos_ids=eos_ids)


# ---------------------------------------------------------------------------
# GGUF-metadata tokenizer (gguf_tokenizer.rs analog)
# ---------------------------------------------------------------------------

_SPM_REPLACEMENT = "▁"  # ▁


def from_gguf_metadata(md: Mapping[str, Any]) -> TokenizerWrapper:
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers

    model_kind = md.get("tokenizer.ggml.model", "llama")
    tokens = [str(t) for t in md["tokenizer.ggml.tokens"]]
    bos_id = md.get("tokenizer.ggml.bos_token_id")
    eos_id = md.get("tokenizer.ggml.eos_token_id")
    add_bos = bool(md.get("tokenizer.ggml.add_bos_token", True))

    if model_kind == "llama":  # SentencePiece Unigram
        scores = md.get("tokenizer.ggml.scores")
        if scores is None:
            scores = [0.0] * len(tokens)
        vocab = [(t, float(s)) for t, s in zip(tokens, scores)]
        unk = int(md.get("tokenizer.ggml.unknown_token_id", 0))
        tok = Tokenizer(models.Unigram(vocab, unk_id=unk, byte_fallback=True))
        tok.normalizer = normalizers.Sequence(
            [normalizers.Replace(" ", _SPM_REPLACEMENT), normalizers.Prepend(_SPM_REPLACEMENT)]
        )
        tok.decoder = decoders.Sequence(
            [
                decoders.Replace(_SPM_REPLACEMENT, " "),
                decoders.ByteFallback(),
                decoders.Fuse(),
                decoders.Strip(" ", 1, 0),
            ]
        )
    elif model_kind == "gpt2":  # byte-level BPE
        merges_raw = md.get("tokenizer.ggml.merges", [])
        merges = [tuple(m.split(" ", 1)) for m in merges_raw]
        vocab = {t: i for i, t in enumerate(tokens)}
        tok = Tokenizer(models.BPE(vocab, merges, ignore_merges=True))
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = decoders.ByteLevel()
    else:
        raise NotImplementedError(f"GGUF tokenizer model {model_kind!r}")

    # register special/control tokens so decode can skip them
    token_types = md.get("tokenizer.ggml.token_type")
    if token_types is not None:
        from tokenizers import AddedToken

        specials = [
            AddedToken(tokens[i], special=True)
            for i, tt in enumerate(token_types)
            if int(tt) in (3, 4)  # CONTROL, USER_DEFINED? (3=control)
        ]
        if specials:
            tok.add_special_tokens(specials)

    return TokenizerWrapper(
        tok,
        bos_id=bos_id,
        eos_ids=(eos_id,) if eos_id is not None else (),
        add_bos=add_bos,
    )
