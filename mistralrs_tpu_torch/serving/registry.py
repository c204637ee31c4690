"""Model registry with one engine thread per model (counterpart of
``mistralrs_tpu/serving/registry.py``: named instances, routing by model id).

Each :class:`ModelInstance` owns a daemon thread that steps its engine while
there is work; ``shutdown()`` stops and joins it. Admission and stepping
share one lock, so request threads never touch the scheduler mid-step.
"""

from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass, field
from typing import Optional

from ..chat_template import ChatTemplate
from ..engine.engine import Engine
from ..engine.sampler import SamplingParams
from ..engine.sequence import Sequence, StopReason


@dataclass
class ModelInstance:
    """One loaded model: engine + its worker thread."""

    model_id: str
    engine: Engine
    tokenizer: object
    chat_template: ChatTemplate
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _wake: threading.Event = field(default_factory=threading.Event)
    _stop: bool = False
    _thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop = False
        self._thread = threading.Thread(target=self._loop, name=f"engine-{self.model_id}",
                                        daemon=True)
        self._thread.start()

    def shutdown(self, timeout: float = 60.0) -> None:
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError(f"engine thread of {self.model_id!r} did not stop")
            self._thread = None

    def _loop(self) -> None:
        while not self._stop:
            with self._lock:
                busy = self.engine.has_work
                if busy:
                    try:
                        self.engine.step()
                    except Exception:  # noqa: BLE001 — keep the engine alive
                        traceback.print_exc()
                        sched = self.engine.scheduler
                        for seq in list(sched.running) + list(sched.waiting):
                            seq.finish(StopReason.ERROR)
                            if seq.on_tokens:
                                seq.on_tokens([], True)
                            sched.release(seq)
            if not busy:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def submit(self, prompt_ids, params: SamplingParams, on_tokens) -> Sequence:
        with self._lock:
            seq = self.engine.add_request(prompt_ids, params, on_tokens=on_tokens)
        self._wake.set()
        return seq


class ModelRegistry:
    """Thread-safe named-model registry with a default model."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models: dict[str, ModelInstance] = {}
        self._default: Optional[str] = None

    def register(self, inst: ModelInstance, default: bool = False) -> None:
        with self._lock:
            old = self._models.get(inst.model_id)
            self._models[inst.model_id] = inst
            if default or self._default is None:
                self._default = inst.model_id
        if old is not None:
            old.shutdown()
        inst.start()

    def get(self, model_id: Optional[str] = None) -> Optional[ModelInstance]:
        with self._lock:
            if model_id in (None, "", "default"):
                model_id = self._default
            return self._models.get(model_id) if model_id else None

    def list(self) -> list[ModelInstance]:
        with self._lock:
            return list(self._models.values())

    @property
    def default_id(self) -> Optional[str]:
        with self._lock:
            return self._default

    def shutdown(self) -> None:
        for inst in self.list():
            inst.shutdown()
