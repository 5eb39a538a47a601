"""Device policy of the port: run on the card unless the caller asks for
the CPU, and never fall back quietly.

Every entry point takes ``device`` (default ``"cuda"``) and passes it
through `resolve`, which raises when CUDA is asked for and missing. The
tests pass ``device="cpu"`` explicitly; there, every kernel wrapper runs
its plain PyTorch version.
"""
from __future__ import annotations

import functools

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a `torch.device`; raises if it names CUDA and no card
    is present, or names anything other than ``cuda``/``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    else:
        settle_cpu()
    return dev


@functools.cache
def settle_cpu() -> None:
    """One small floating-point pass before a process's first CPU work,
    once per process. On some AVX-512 hosts the first vectorized
    floating-point pass of a process can return wrong values for a run of
    one thread's elements (two identical calls of the noise stream, and
    even of `torch.sqrt`, then differ by up to 4e-5); after any earlier
    pass, every call reproduces."""
    torch.sqrt(torch.ones(64))
