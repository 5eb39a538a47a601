"""The benchmark's yardstick for rooflines and peaks: operations and bytes
that each counted piece of work needs (one file a piece), and the chip's
published peaks (`peaks.json`, by the device name the card reports).

A count takes each input byte read once and each output byte written once,
and only what these inputs need (real users, live entries), whatever a
kernel reads again; so the count stays fixed whatever implements the work.
"""
from __future__ import annotations

import functools
import json
import pathlib


@functools.cache
def _peaks() -> dict:
    return json.loads(pathlib.Path(__file__).with_name("peaks.json").read_text())


def peaks_for(kind: str) -> dict | None:
    """The published peaks of the device named ``kind``, or None."""
    return _peaks().get(kind)


def least_seconds(nbytes: float, flops: float, peaks: dict) -> float:
    """The least time the chip could take: the larger of the bytes over the
    memory bandwidth and the operations over the float32 rate."""
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["fp32_flops_per_s"])
