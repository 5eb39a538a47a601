"""Row layout of learner sharding — port of `rows_per_shard` and
`shard_row_slices` (`src/repro/sharding/dmf.py:61-74`) as integer math.
The sharded epoch, outbox and SPMD serving are not ported yet."""
from __future__ import annotations


def rows_per_shard(n_users: int, n_shards: int) -> int:
    return -(-n_users // n_shards)


def shard_row_slices(n_rows: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) unpadded row ranges per shard under the
    ceil-div layout of `rows_per_shard` (the trailing shards may be short
    or empty). The tiled store's row sharding (`serving/store.py`
    `shard_rows`) slices along these, so a request routes to shard
    ``user // rows_per_shard``."""
    rows = rows_per_shard(n_rows, n_shards)
    return [(min(d * rows, n_rows), min((d + 1) * rows, n_rows))
            for d in range(n_shards)]
