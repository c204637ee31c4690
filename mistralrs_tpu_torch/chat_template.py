"""Jinja chat-template engine (a copy of ``mistralrs_tpu/chat_template.py``;
the analog of the reference's minijinja-based
`mistralrs-core/src/pipeline/chat_template.rs` + `chat_templates/`).

Templates come from (in priority order): explicit override, HF
`tokenizer_config.json` `chat_template`, GGUF `tokenizer.chat_template`
metadata, or a per-arch fallback. The port adds one fallback to the JAX
package's: the gemma family's turns (``<start_of_turn>user`` ...
``<end_of_turn>``, the assistant as ``model``, a system message put before
the first user turn's text, as Gemma-3's own template does).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

import jinja2

# fallback templates (analog of chat_templates/*.json)
FALLBACK_TEMPLATES = {
    "chatml": (
        "{% for message in messages %}"
        "{{'<|im_start|>' + message['role'] + '\n' + message['content'] + '<|im_end|>' + '\n'}}"
        "{% endfor %}"
        "{% if add_generation_prompt %}{{ '<|im_start|>assistant\n' }}{% endif %}"
    ),
    "llama3": (
        "{% for message in messages %}"
        "{{'<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n' + message['content'] | trim + '<|eot_id|>'}}"
        "{% endfor %}"
        "{% if add_generation_prompt %}{{'<|start_header_id|>assistant<|end_header_id|>\n\n'}}{% endif %}"
    ),
    "gemma": (
        "{{ bos_token }}"
        "{% set ns = namespace(prefix='') %}"
        "{% for message in messages %}"
        "{% if message['role'] == 'system' %}{% set ns.prefix = message['content'] + '\n\n' %}"
        "{% else %}"
        "{{ '<start_of_turn>' + ('model' if message['role'] == 'assistant' else message['role'])"
        " + '\n' + ns.prefix + message['content'] | trim + '<end_of_turn>\n' }}"
        "{% set ns.prefix = '' %}"
        "{% endif %}"
        "{% endfor %}"
        "{% if add_generation_prompt %}{{ '<start_of_turn>model\n' }}{% endif %}"
    ),
    "mistral": (
        "{% for message in messages %}"
        "{% if message['role'] == 'user' %}{{ '[INST] ' + message['content'] + ' [/INST]' }}"
        "{% elif message['role'] == 'assistant' %}{{ message['content'] + '</s>' }}"
        "{% else %}{{ message['content'] }}{% endif %}"
        "{% endfor %}"
    ),
}


class ChatTemplate:
    def __init__(
        self,
        template: str,
        bos_token: str = "",
        eos_token: str = "",
        unk_token: str = "",
    ):
        self.source = template
        env = jinja2.Environment(
            loader=jinja2.BaseLoader(),
            trim_blocks=True,
            lstrip_blocks=True,
            extensions=["jinja2.ext.loopcontrols"],
        )
        env.globals["raise_exception"] = _raise_exception
        env.filters["tojson"] = lambda x, **kw: json.dumps(x, **kw)
        self._tmpl = env.from_string(template)
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.unk_token = unk_token

    def render(
        self,
        messages: Sequence[Mapping[str, Any]],
        add_generation_prompt: bool = True,
        tools: Optional[Sequence[Mapping[str, Any]]] = None,
        **extra,
    ) -> str:
        return self._tmpl.render(
            messages=list(messages),
            add_generation_prompt=add_generation_prompt,
            tools=list(tools) if tools else None,
            bos_token=self.bos_token,
            eos_token=self.eos_token,
            unk_token=self.unk_token,
            **extra,
        )


def _raise_exception(msg: str):
    raise jinja2.exceptions.TemplateError(msg)


def resolve_chat_template(
    *,
    override: Optional[str] = None,
    hf_dir: Optional[str | Path] = None,
    gguf_metadata: Optional[Mapping[str, Any]] = None,
    arch: Optional[str] = None,
    bos_token: str = "",
    eos_token: str = "",
) -> ChatTemplate:
    src: Optional[str] = override
    if src is None and hf_dir is not None:
        p = Path(hf_dir) / "tokenizer_config.json"
        if p.exists():
            tc = json.loads(p.read_text())
            t = tc.get("chat_template")
            if isinstance(t, list):  # multiple named templates
                t = next((e["template"] for e in t if e.get("name") == "default"), None)
            if t:
                src = t
            bos = tc.get("bos_token")
            eos = tc.get("eos_token")
            if isinstance(bos, dict):
                bos = bos.get("content", "")
            if isinstance(eos, dict):
                eos = eos.get("content", "")
            bos_token = bos_token or (bos or "")
            eos_token = eos_token or (eos or "")
    if src is None and gguf_metadata is not None:
        src = gguf_metadata.get("tokenizer.chat_template")
    if src is None:
        key = {
            "llama": "llama3",
            "mistral": "mistral",
            "gemma": "gemma",
            "gemma2": "gemma",
            "gemma3": "gemma",
        }.get(arch or "", "chatml")
        src = FALLBACK_TEMPLATES[key]
    return ChatTemplate(src, bos_token=bos_token, eos_token=eos_token)
