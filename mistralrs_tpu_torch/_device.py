"""Device resolution for the port's entry points.

``cuda`` is the default; the CPU is used only when the caller asks for it
(the tests do), and a missing card is an error, never a silent fallback."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

IO_CHUNK = 64 << 20  # bytes a read or write moves between a card and the host at a time


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda:0``; ``"cpu"`` → the CPU; raises when a CUDA device
    is asked for (explicitly or by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def weights_device(weights: dict, device: DeviceLike = None) -> torch.device:
    """The device of a library entry point that takes a model's weights:
    ``device`` resolved as :func:`resolve_device` resolves it (``cuda``
    unless the caller asks for ``"cpu"``); raises when the weights lie
    elsewhere."""
    dev = resolve_device(device)
    have = weights["embed"].device
    if have.type != dev.type or (dev.type == "cuda" and have.index != dev.index):
        raise ValueError(f"the weights are on {have}, not on {dev}")
    return dev


def read_bytes(path, offset: int, nbytes: int, device: DeviceLike = "cpu",
               name: str = "a tensor") -> torch.Tensor:
    """``nbytes`` of the file ``path`` from ``offset`` as a flat uint8
    tensor on ``device``: on a card copied there in chunks of
    :data:`IO_CHUNK` bytes, so the host holds one chunk, not the tensor.
    A file that ends first raises ``ValueError`` naming ``name``."""
    dev = torch.device(device)
    out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    step = nbytes if dev.type == "cpu" else IO_CHUNK
    buf = out if dev.type == "cpu" else torch.empty(min(step, nbytes), dtype=torch.uint8)
    with open(path, "rb") as f:
        f.seek(offset)
        for lo in range(0, nbytes, step):
            n = min(step, nbytes - lo)
            if f.readinto(buf[:n].numpy()) != n:
                raise ValueError(f"{path}: {name} runs past the end of the file")
            if buf is not out:
                out[lo:lo + n].copy_(buf[:n])
    return out
