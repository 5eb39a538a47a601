"""Deterministic accumulating scatter of the port: ``target[indices] +=
values`` with duplicate index tuples summed in the same order on every run.

The reference's XLA scatters give the same bits on every run; PyTorch's
two obvious forms do not on every device (the
`torch.use_deterministic_algorithms` docstring lists
``index_put_(accumulate=True)`` as non-deterministic on a CPU tensor and
``index_add_`` as non-deterministic on a CUDA tensor). So each device takes
the form that is deterministic there, without touching the global switch:

* CPU: ``index_add_`` over the rows of a 2-D view, the index tuple
  linearized (``rows * J + cols``). It adds the updates one after the
  other in their order.
* CUDA: ``index_put_(accumulate=True)``, which sorts the linear indices
  (a stable radix sort) and sums each run of duplicates in that order.

The two devices may sum the same duplicates in another order, so card vs
CPU still differ by fp32 rounding order; each is the same on every run.
"""
from __future__ import annotations

import torch


def scatter_add_rows_(target: torch.Tensor, indices: tuple[torch.Tensor, ...],
                      values: torch.Tensor) -> torch.Tensor:
    """``target[indices] += values`` in place, as
    ``target.index_put_(indices, values, accumulate=True)`` computes it,
    in a fixed order on each device. ``indices`` index the leading
    ``len(indices)`` dims of ``target`` (they broadcast against each
    other); ``values`` has the broadcast index shape followed by the
    trailing dims of ``target``. ``target`` must be contiguous. Returns
    ``target``."""
    n_lead = len(indices)
    lead, row = target.shape[:n_lead], target.shape[n_lead:]
    lin = indices[0].to(torch.int64)
    for idx, size in zip(indices[1:], lead[1:]):
        lin = lin * size + idx.to(torch.int64)
    lin = lin.reshape(-1)
    flat = target.view(-1, *row)
    vals = values.reshape(lin.shape[0], *row)
    if target.device.type == "cuda":
        flat.index_put_((lin,), vals, accumulate=True)
    else:
        flat.index_add_(0, lin, vals)
    return target
