"""Model registry with one engine thread per model (counterpart of
``mistralrs_tpu/serving/registry.py``: named instances, routing by model id,
load, unload and reload at runtime).

Each :class:`ModelInstance` owns a daemon thread that steps its engine while
there is work; ``shutdown()`` stops and joins it. Admission and stepping
share the instance's lock, so request threads never touch the scheduler
mid-step, and its embeddings run under the same lock, between steps. Every
engine's step also holds its device's lock (``ops/_cuda.py::device_lock``),
so the models served on one card take turns on the kernels' shared split
state. A load reads the model and places its weights on the card without
that lock (the models already served go on stepping: a capture tolerates
allocations on other threads, ``engine/decode_step.py``), and takes it only
to build the engine, which reserves the split state and its pools; an
unload frees the engine's memory under it.
"""

from __future__ import annotations

import gc
import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..chat_template import ChatTemplate
from ..engine.engine import Engine
from ..engine.sampler import SamplingParams
from ..engine.sequence import Sequence, StopReason
from ..ops._cuda import device_lock


@dataclass
class ModelInstance:
    """One loaded model: engine + its worker thread."""

    model_id: str
    engine: Engine
    tokenizer: object
    chat_template: ChatTemplate
    source: Optional[str] = None  # path, for reload
    load_options: dict[str, Any] = field(default_factory=dict)
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

    def embed(self, token_batches, pooling: str = "last") -> np.ndarray:
        """``Engine.embed`` under the instance's lock (between its steps)."""
        with self._lock:
            return self.engine.embed(token_batches, pooling=pooling)


class ModelRegistry:
    """Thread-safe named-model registry with a default model. Models loaded
    by :meth:`load` go to the device of the first model registered (the
    card when there is none)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models: dict[str, ModelInstance] = {}
        self._default: Optional[str] = None
        self.device: Optional[torch.device] = None

    def register(self, inst: ModelInstance, default: bool = False) -> None:
        with self._lock:
            old = self._models.get(inst.model_id)
            self._models[inst.model_id] = inst
            if default or self._default is None:
                self._default = inst.model_id
            if self.device is None:
                self.device = inst.engine.device
        if old is not None:
            _release(old)
        inst.start()

    def load(
        self,
        model_id: str,
        path: str,
        *,
        default: bool = False,
        isq: Optional[str] = None,
        engine_options: Optional[dict[str, Any]] = None,
        imatrix: Optional[str] = None,
    ) -> ModelInstance:
        """Load a model from disk (``pipeline.load_pipeline``: a ``.gguf`` or
        ``.uqff`` file or a HF directory) onto the registry's device, build
        its engine (``engine_options`` are ``Engine`` keywords) with the
        model's tokenizer, and register it (the /v1/models/load analog).
        The models already served on the card step on while it reads and
        places the weights (the disk read, any ISQ); they wait only while
        the engine is built under the device's lock."""
        from ..models.llama import fuse_projections
        from ..pipeline import load_pipeline

        dev = resolve_device(self.device)
        pipe = load_pipeline(path, isq=isq, imatrix=imatrix, device=dev)
        if pipe.tokenizer is None:
            raise ValueError(f"{path}: the model has no tokenizer; serving needs one")
        weights = None if pipe.adapter is not None else fuse_projections(pipe.weights, pipe.cfg)
        with device_lock(dev):
            engine = Engine(pipe.cfg, weights, adapter=pipe.adapter, tokenizer=pipe.tokenizer,
                            device=dev, **(engine_options or {}))
        inst = ModelInstance(
            model_id=model_id,
            engine=engine,
            tokenizer=pipe.tokenizer,
            chat_template=pipe.chat_template,
            source=path,
            load_options={"isq": isq, "engine_options": engine_options or {},
                          "imatrix": imatrix},
        )
        self.register(inst, default=default)
        return inst

    def unload(self, model_id: str) -> bool:
        """Stop a model's engine thread and release its device memory (the
        decode step's graphs and pool, the KV pools, the weights)."""
        with self._lock:
            inst = self._models.pop(model_id, None)
            if self._default == model_id:
                self._default = next(iter(self._models), None)
        if inst is None:
            return False
        _release(inst)
        return True

    def reload(self, model_id: str) -> bool:
        with self._lock:
            inst = self._models.get(model_id)
        if inst is None or inst.source is None:
            return False
        opts = inst.load_options
        self.load(
            model_id, inst.source,
            isq=opts.get("isq"), engine_options=opts.get("engine_options"),
            imatrix=opts.get("imatrix"),
        )
        return True

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


def _release(inst: ModelInstance) -> None:
    """Join an instance's engine thread (its requests in flight end with
    ERROR), then free its engine's device memory under the device's lock."""
    inst.shutdown()
    engine = inst.engine
    sched = engine.scheduler
    for seq in list(sched.running) + list(sched.waiting):
        seq.finish(StopReason.ERROR)
        if seq.on_tokens:
            seq.on_tokens([], True)
        sched.release(seq)
    dev = engine.device
    with device_lock(dev):
        engine.close()
        del engine, sched
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
