"""Independent seeds derived from a run's ``--seed`` (any whole number),
one stream a purpose, so that one seed gives the same inputs every run."""
from __future__ import annotations

import numpy as np

STREAMS = {"factors": 1, "order": 2, "check": 3, "jobs": 4, "warmup": 5}


def sub_seed(seed: int, stream: str, *index: int) -> int:
    """A 63-bit seed for ``stream`` (and an index within it)."""
    words = [seed & (2 ** 64 - 1), STREAMS[stream], *index]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))
