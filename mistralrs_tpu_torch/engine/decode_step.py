"""The engine's decode step as one captured CUDA graph per block-table width
(counterpart of ``_decode_fn``, ``mistralrs_tpu/engine/engine.py:69-83``:
the jitted forward plus ``sample`` over the fixed slot batch, the cache and
the sampling state threaded through donated buffers).

:class:`DecodeStep` owns the step's static buffers: per width bucket a
staging buffer ``[B, 4 + W]`` int32 (token, position, write slot, kv_len,
then the block table) filled on the host in pinned memory and sent with one
non-blocking copy, and the outputs (tokens, logprobs, top-logprob values and
ids) brought back into pinned memory with non-blocking copies and one event
wait, the step's only host sync. :meth:`DecodeStep.compute` is the step
function: the forward the engine gives it, then :func:`~.sampler.sample`
over every slot (empty slots draw too; their tokens are ignored), the KV
rows and the sampling state updated in place.

On CUDA, the first step at a width warms that width up eagerly on a side
stream with every row empty (slot -1 and kv_len 0, so the writes go to the
trash slot and no count moves), which runs the lazy set-up (library load,
kernel attributes, plans), then captures ``compute`` into a graph that
shares one memory pool with the other widths' graphs, and every step
replays it. A capture or replay error raises: there is no eager fallback.
The capture holds the device's lock (the engine steps under it) but
tolerates other threads' allocations (``capture_error_mode="thread_local"``):
a model loading beside the engine reads and places its weights unlocked.
The kernels' split workspace and counters are reserved before the first
capture, at the size the engine works out from the kernels' plans for every
width and every forward it runs (the eager prefill included, which must not
grow them while a graph lives; ``ops/_cuda.py``). The weights the kernels
read in place (gpt-oss's f32 sinks among them) are the engine's own
tensors, so their addresses hold for a graph's life. On the CPU (the caller
asked for it) the same function runs uncaptured.

The engine writes a slot's constraint-bias row (grammar mask plus DRY
penalty, computed on the host after each step) with :meth:`set_bias_row`:
a non-blocking copy, on the engine's stream, from that slot's row of a
pinned host buffer into ``constraint_bias[slot]`` in place, so the next
replay reads it at the address it captured. A host row is rewritten only
after its last copy has completed: each copy records an event of its slot,
and a rewrite waits on it. Between two decode steps that wait never
blocks, as the step's one event wait (recorded after the replay, which
follows the copy on the same stream) has already passed it.
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops import _cuda
from .sampler import TOP_LOGPROBS, BatchSamplingState, sample

TOKEN, POSITION, SLOT, KV_LEN, TABLE = 0, 1, 2, 3, 4  # staging columns


class StepOutput(NamedTuple):
    tokens: torch.Tensor  # [B] i64
    logprobs: torch.Tensor  # [B] f32
    top_vals: torch.Tensor  # [B, k] f32
    top_ids: torch.Tensor  # [B, k] i64
    logits: torch.Tensor  # [B, V] f32, before penalties


class DecodeStep:
    """One decode step of ``batch`` slots: ``forward(tokens [B, 1],
    positions [B, 1], block_tables [B, W], slot_map [B, 1], kv_lens [B])``
    returns the logits ``[B, 1, V]`` and updates the cache in place;
    ``workspace`` is the kernels' split state (``(f32 values, int32
    counters)``) that any forward on the device takes, reserved here."""

    def __init__(self, forward: Callable, samp_state: BatchSamplingState, batch: int,
                 device: torch.device, workspace: tuple[int, int] = (0, 0)):
        self.forward = forward
        self.state = samp_state
        self.batch = batch
        self.device = device
        self.cuda = device.type == "cuda"
        self._host: dict[int, torch.Tensor] = {}
        self._dev: dict[int, torch.Tensor] = {}
        self._graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self._outs: dict[int, StepOutput] = {}
        self._launches: dict = {}
        self._pool = None
        self._release = None  # drops the hold on the split buffers
        self.capture_seconds = 0.0  # host time spent warming up and capturing graphs
        k = min(TOP_LOGPROBS, samp_state.counts.shape[1])
        pin = dict(pin_memory=self.cuda)
        self._results = (torch.empty(batch, dtype=torch.long, **pin),
                         torch.empty(batch, dtype=torch.float32, **pin),
                         torch.empty((batch, k), dtype=torch.float32, **pin),
                         torch.empty((batch, k), dtype=torch.long, **pin))
        self._done = torch.cuda.Event() if self.cuda else None
        self._bias_host = torch.zeros(samp_state.constraint_bias.shape, dtype=torch.float32,
                                      pin_memory=self.cuda)
        self._bias_copied = [torch.cuda.Event() if self.cuda else None for _ in range(batch)]
        if self.cuda:
            _cuda.reserve(device, *workspace)

    def staging(self, width: int) -> np.ndarray:
        """The host staging ``[B, 4 + width]`` int32 of a step at ``width``
        (a view of pinned memory on CUDA), filled with empty rows: token 0,
        position 0, slot -1 (the write goes to the trash slot), kv_len 0,
        block table 0. The caller fills the live rows, then :meth:`launch`."""
        host = self._host.get(width)
        if host is None:
            host = torch.empty((self.batch, TABLE + width), dtype=torch.int32,
                               pin_memory=self.cuda)
            self._host[width] = host
            self._dev[width] = torch.empty_like(host, device=self.device)
        a = host.numpy()
        a.fill(0)
        a[:, SLOT] = -1
        return a

    def set_bias_row(self, slot: int, row: "np.ndarray | None") -> None:
        """Write ``row`` ([V] f32; None → zeros) into the sampling state's
        ``constraint_bias[slot]`` before the next step, without a host sync
        on CUDA (see the module docstring)."""
        ev = self._bias_copied[slot]
        if ev is not None:
            ev.synchronize()  # the last copy from this host row has completed
        host = self._bias_host[slot]
        if row is None:
            host.zero_()
        else:
            host.numpy()[:] = row
        self.state.constraint_bias[slot].copy_(host, non_blocking=self.cuda)
        if ev is not None:
            ev.record()

    def upload(self, width: int) -> None:
        """Send the host staging of ``width`` to its device buffer (one
        non-blocking copy)."""
        self._dev[width].copy_(self._host[width], non_blocking=True)

    def compute(self, width: int) -> StepOutput:
        """The step function the graph captures: the forward over the device
        staging of ``width``, then sampling over every slot (rows with
        kv_len 0 leave their sampling state as it was)."""
        s = self._dev[width]
        kv_lens = s[:, KV_LEN].contiguous()
        logits = self.forward(s[:, TOKEN:TOKEN + 1].long(), s[:, POSITION:POSITION + 1].long(),
                              s[:, TABLE:].contiguous(), s[:, SLOT:SLOT + 1].contiguous(),
                              kv_lens)[:, 0]
        toks, logprobs, (top_vals, top_ids) = sample(logits, self.state, update=kv_lens > 0)
        return StepOutput(toks, logprobs, top_vals, top_ids, logits)

    def graph_output(self, width: int) -> StepOutput:
        """The static outputs of ``width``'s graph (rewritten by every
        replay)."""
        return self._outs[width]

    def launch(self, width: int) -> StepOutput:
        """Run the step of the staging at ``width`` (a graph replay on
        CUDA, captured at the first step of this width) and start the copies
        of its results to the host; :meth:`wait` returns them. No host sync
        on CUDA past the first step of a width."""
        if self.cuda and width not in self._graphs:
            self._capture(width)
        self.upload(width)
        if self.cuda:
            self._graphs[width].replay()
            _cuda.add_launches(self._launches[width])
            out = self._outs[width]
        else:
            out = self.compute(width)
        for host, dev in zip(self._results, out):
            host.copy_(dev, non_blocking=True)
        if self.cuda:
            self._done.record()
        return out

    def wait(self):
        """The last launched step's (tokens, logprobs, top_vals, top_ids) as
        host numpy arrays, after its one event wait."""
        if self.cuda:
            self._done.synchronize()
        return tuple(t.numpy().copy() for t in self._results)

    def run(self, width: int):
        """:meth:`launch` then :meth:`wait`."""
        self.launch(width)
        return self.wait()

    def _capture(self, width: int) -> None:
        t0 = time.monotonic()
        dev, stream = self._dev[width], torch.cuda.current_stream(self.device)
        dev.zero_()
        dev[:, SLOT] = -1
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self.compute(width)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _cuda.recording_launches() as launches:
            # thread_local: a model loading on another thread may allocate
            # (cudaMalloc) while this captures; only this thread's calls
            # must be capture-safe
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                out = self.compute(width)
        if self._pool is None:
            self._pool = graph.pool()
        if self._release is None:
            _cuda.hold_buffers(self.device)
            self._release = weakref.finalize(self, _cuda.release_buffers, self.device)
        self._graphs[width], self._outs[width] = graph, out
        self._launches[width] = launches
        self.capture_seconds += time.monotonic() - t0

    def close(self) -> None:
        """Drop the graphs, their memory pool, outputs and staging buffers
        (the split buffers may grow again once no graph holds them;
        collecting the object does the same). A later step captures
        again."""
        self._graphs.clear()
        self._outs.clear()
        self._launches.clear()
        self._dev.clear()
        self._host.clear()
        self._pool = None
        if self._release is not None:
            self._release()
            self._release = None
