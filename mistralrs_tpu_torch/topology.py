"""Per-layer-range quantization topology (a copy of
``mistralrs_tpu/topology.py``, the analog of mistral.rs's topology YAML
files):

    0-8:
      isq: Q3K
    8-16:
      isq: Q4K
    16-:
      isq: Q8_0

Ranges are ``[start, end)`` layer indices (an open end runs to the last
layer); later entries override earlier ones; ``isq: null`` leaves a range
at the default. ``models/hf_loader.py`` takes a :class:`Topology` with an
``isq`` type: a layer's quantized tensors take the topology's type where
it names one and the ``isq`` type elsewhere, as the JAX loader resolves
them (``hf_loader.py:276-290``); without an ``isq`` type it is ignored, as
there. PyYAML is imported only by :meth:`Topology.from_yaml`.
"""

from __future__ import annotations

import re
from typing import Optional

from .gguf.constants import GGMLType

_ISQ_NAMES = {
    "Q2K": GGMLType.Q2_K, "Q3K": GGMLType.Q3_K, "Q4K": GGMLType.Q4_K,
    "Q5K": GGMLType.Q5_K, "Q6K": GGMLType.Q6_K,
    "Q4_0": GGMLType.Q4_0, "Q4_1": GGMLType.Q4_1,
    "Q5_0": GGMLType.Q5_0, "Q5_1": GGMLType.Q5_1, "Q8_0": GGMLType.Q8_0,
}

_RANGE_RE = re.compile(r"^(\d+)\s*-\s*(\d*)$")


class Topology:
    """Resolved per-layer ISQ assignment."""

    def __init__(self, per_layer: list[Optional[GGMLType]]):
        self.per_layer = per_layer

    @classmethod
    def from_dict(cls, spec: dict, num_layers: int,
                  default: Optional[GGMLType] = None) -> "Topology":
        per_layer: list[Optional[GGMLType]] = [default] * num_layers
        for key, entry in spec.items():
            m = _RANGE_RE.match(str(key).strip())
            if not m:
                raise ValueError(f"bad topology range {key!r} (want 'start-end')")
            start = int(m.group(1))
            end = int(m.group(2)) if m.group(2) else num_layers
            if not (0 <= start < end <= num_layers):
                raise ValueError(f"topology range {key!r} out of bounds for {num_layers} layers")
            isq = (entry or {}).get("isq")
            t = None
            if isq is not None:
                name = str(isq).upper().replace("-", "_")
                if name not in _ISQ_NAMES:
                    raise ValueError(f"unknown topology isq type {isq!r}")
                t = _ISQ_NAMES[name]
            for i in range(start, end):
                per_layer[i] = t
        return cls(per_layer)

    @classmethod
    def from_yaml(cls, text: str, num_layers: int,
                  default: Optional[GGMLType] = None) -> "Topology":
        import yaml

        return cls.from_dict(yaml.safe_load(text) or {}, num_layers, default)

    def type_for_layer(self, i: int) -> Optional[GGMLType]:
        return self.per_layer[i]
