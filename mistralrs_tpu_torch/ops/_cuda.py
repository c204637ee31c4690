"""Build and load the port's CUDA kernels, and count their launches.

The sources under ``csrc/`` (``SOURCES``; the ``.cuh`` headers they include
are part of the build's key) are compiled by one ``nvcc`` process each, all
started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``. The build happens on first use (never at
import), goes to ``_build/`` inside the package (the directory is
git-ignored), and is keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a non-zero code (:func:`check`).

Launch counts: every kernel wrapper adds one to ``COUNTS[name]`` where it
launches its kernel, and every plain PyTorch version adds one to
``COUNTS[name + "_plain"]``; the W4 and W8 launches, dense and grouped, also
add one to ``COUNTS[name + ".decode"]`` or ``COUNTS[name + ".prefill"]``, the
body their plan ran. A run resets them with :func:`reset_counts` and reads them
afterwards to show which path it went through.

The kernels that split their work across blocks share per-device state
here: :func:`split_workspace` (f32 partials) and :func:`split_counters` (int
counters, zero between calls: the last block of a tile resets its own).
Calls that use them on one device must not run on two streams at once:
every user of a device's forwards (an engine's step, its embeddings, the
building and release of another model's engine beside it) holds
:func:`device_lock` of that device, so several models served on one card
take turns.

CUDA graphs: a captured launch keeps the address of the buffer it was given,
so these buffers must not be replaced while a graph that uses them lives.
:func:`reserve` sizes both before the first capture (the engine works the
sizes out from the kernels' plans for every forward it runs), and between
:func:`hold_buffers` and :func:`release_buffers`, or while the current
stream captures, a call that would grow one raises in place of
reallocating it. A capture runs every wrapper once without launching
anything: :func:`recording_launches` takes those counts back out of
``COUNTS`` and hands them to the caller, who adds them once per replay
(:func:`add_launches`).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# the paged attention kernels' head dims, each compiled in a source of its
# own (their bodies in csrc/paged_attention.cuh, their C entry points in
# paged_attention.cu, whose PA_HEAD_DIMS lists the same)
PAGED_HEAD_DIMS = (64, 80, 96, 128, 256)
SOURCES = ("w4_matmul.cu", "w8_matmul.cu", "w8_prefill.cu", "dense_grouped.cu",
           "paged_attention.cu", *(f"paged_attention_hd{d}.cu" for d in PAGED_HEAD_DIMS),
           "mla_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
)

KERNELS = ("w4_matmul", "w8_matmul", "w4_matmul_wide", "w8_matmul_wide", "w4_matmul_g16",
           "w8_matmul_e4m3",
           "paged_decode", "paged_prefill",
           "w4_matmul_g", "w8_matmul_g", "w4_matmul_wide_g", "w8_matmul_wide_g",
           "w4_matmul_g16_g",
           "dense_matmul_g", "mla_decode",
           "paged_decode_int8", "paged_decode_fp8", "paged_prefill_int8", "paged_prefill_fp8",
           "paged_decode_hd256", "paged_prefill_hd256", "paged_decode_hd64",
           "paged_prefill_hd64", "paged_decode_int8_hd256", "paged_decode_int8_hd64",
           "paged_decode_fp8_hd256", "paged_decode_fp8_hd64", "paged_prefill_int8_hd256",
           "paged_prefill_int8_hd64", "paged_prefill_fp8_hd256", "paged_prefill_fp8_hd64",
           *(f"paged_{k}{q}_hd{d}" for d in (80, 96) for k in ("decode", "prefill")
             for q in ("", "_int8", "_fp8")))
COUNTS: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures: every pointer and the stream are c_void_p, every int c_int,
# every bank stride c_longlong
_SIGNATURES = {
    "mrt_dense_matmul_grouped": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P],
    "mrt_w4_matmul": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _L, _L,
                      _P, _P, _P],
    "mrt_w8_matmul": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _L, _L, _P, _P, _P],
    "mrt_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _I, _F, _P],
    "mrt_paged_prefill": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _F, _P],
    # the quantized forms: the bf16 form's arguments, then the scale planes
    # and the code type before the stream (prefill: and the round trips)
    "mrt_paged_decode_q": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _I, _F,
                           _P, _P, _I, _P],
    "mrt_paged_prefill_q": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _F,
                            _P, _P, _I, _P, _P, _P],
    "mrt_mla_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None
_sm_counts: dict = {}
_workspaces: dict = {}
_counters: dict = {}
_held: collections.Counter = collections.Counter()  # device -> live graphs using the buffers
_device_locks: dict = {}


def reset_counts() -> None:
    COUNTS.clear()


@contextlib.contextmanager
def recording_launches():
    """Count the launches the wrappers report inside the block, take them
    back out of ``COUNTS`` and yield them (a capture launches nothing: its
    graph adds them once per replay)."""
    before = COUNTS.copy()
    recorded: collections.Counter = collections.Counter()
    try:
        yield recorded
    finally:
        for name, n in COUNTS.items():
            if n != before[name]:
                recorded[name] = n - before[name]
        COUNTS.clear()
        COUNTS.update(+before)


def add_launches(recorded: collections.Counter) -> None:
    """Add a graph's recorded launches to ``COUNTS`` (one replay)."""
    COUNTS.update(recorded)


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA ``device`` (the kernels' plans size their grids
    by it)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def _may_grow(device: torch.device, what: str, n: int) -> None:
    if _held[device] or (device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(
            f"the split {what} on {device} would grow to {n} while a CUDA graph uses it: "
            f"reserve() it before the first capture")


def split_workspace(device: torch.device, floats: int) -> torch.Tensor:
    """An f32 workspace of at least ``floats`` values on ``device`` (reused
    by every split body; its contents are scratch)."""
    ws = _workspaces.get(device)
    if ws is None or ws.numel() < floats:
        _may_grow(device, "workspace", floats)
        ws = torch.empty(max(floats, 1 << 20), dtype=torch.float32, device=device)
        _workspaces[device] = ws
    return ws


def split_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters on ``device``, zero between calls: each
    split body's last block to arrive resets the counter it used."""
    cnt = _counters.get(device)
    if cnt is None or cnt.numel() < n:
        _may_grow(device, "counters", n)
        cnt = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = cnt
    return cnt


def device_lock(device: torch.device) -> threading.RLock:
    """The one lock of ``device`` that serialises the work on it that shares
    its split state or may race a capture (steps, embeddings, reservations,
    an engine's construction and release; re-entrant)."""
    with _lock:
        return _device_locks.setdefault(torch.device(device), threading.RLock())


def reserve(device: torch.device, floats: int, counters: int) -> None:
    """Allocate the split workspace and counters on ``device`` at these
    sizes at least, now (before a graph captures them). Raises when they
    must grow while a graph holds them (another engine's on the device)."""
    with device_lock(device):
        split_workspace(device, floats)
        split_counters(device, counters)


def hold_buffers(device: torch.device) -> None:
    """A graph that uses the split buffers on ``device`` is alive: from now
    until the matching :func:`release_buffers`, growing them raises."""
    _held[device] += 1


def release_buffers(device: torch.device) -> None:
    _held[device] -= 1


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call. Raises when there is
    no CUDA device or no ``nvcc``."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA kernels need a CUDA device; none is available")
        out = BUILD_DIR / f"libmrt_kernels_{_source_key()}.so"
        if not out.exists():
            import time

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.monotonic()
            _build(out)
            build_seconds = time.monotonic() - t0
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _build(out: Path) -> None:
    """Compile every source to an object (one ``nvcc`` each, in parallel),
    then link the objects into ``out``."""
    tag = f"tmp{os.getpid()}"
    nvcc = nvcc_path()
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        failed = [f"{s} ({p.returncode}):\n{log}"
                  for s, p, log in zip(SOURCES, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = out.with_suffix(f".{tag}")
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device (the cheap
    getter PyTorch's own kernel launchers use, where this build has it)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    """Input validation for the kernel wrappers (raises, never skipped)."""
    if not cond:
        raise ValueError(msg)
