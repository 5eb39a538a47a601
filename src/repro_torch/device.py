"""Device policy of the port: run on the card unless the caller asks for
the CPU, and never fall back quietly.

Every entry point takes ``device`` (default ``"cuda"``) and passes it
through `resolve`, which raises when CUDA is asked for and missing. The
tests pass ``device="cpu"`` explicitly; there, every kernel wrapper runs
its plain PyTorch version.
"""
from __future__ import annotations

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
    return dev
