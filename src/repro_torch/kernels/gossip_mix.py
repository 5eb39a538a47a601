"""Random-walk propagation mixing Y = M @ X — port of `_mix_kernel` /
`gossip_mix_kernel_call` (`src/repro/kernels/gossip_mix.py:22-55`) behind
`ops.gossip_mix_op` (`src/repro/kernels/ops.py:130-137`).

Alg. 1 lines 13-15 vectorized: M (I, I) is the walk-propagation matrix
(`graph.walk_propagation_matrix`), X (I, F) the flattened per-learner
global state (or a block of gradient messages). The CUDA kernels
(``csrc/gossip_mix.cu``) take one of two routes, both one ascending-k fp32
FMA chain per output, so they give the same bits for finite X:

* **sparse**, for M as sparse as the walk matrix: count M's nonzeros (and
  check X for non-finite values), compress M's rows (CSR, ascending
  columns), and accumulate only the X rows of the nonzeros;
* **dense**, a register-tiled SGEMM with a cp.async pipeline, for dense M,
  for non-finite X (0·Inf is NaN in the plain product, and the sparse
  route skips the zeros) and for products too small to be worth the
  count's host round trip.

The ragged I and F edges are predicated, where the TPU wrapper padded both
to 128.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_MAX_ROWS = 65_535 * 64   # the dense grid's y limit times its 64-row tile
# The sparse route runs when nonzeros · SPARSE_DENSITY_INV <= I²: a nonzero
# costs F gathered loads from L2 where the dense product spends 2·I·F
# operations a row of M (`csrc/gossip_mix.cu`, "Threshold").
SPARSE_DENSITY_INV = 16
# Products of at most this many operations go dense without counting: the
# dense bound is then under ~15 µs at 67 TFLOP/s, about the cost of the
# count's host round trip, so the sparse route could not save more than the
# decision costs.
COUNT_MIN_FLOPS = 2 ** 30


def counts_needed(I: int, F: int) -> bool:
    """True if the route of an (I, I) @ (I, F) product is chosen from M's
    nonzero count; False sends it dense without counting."""
    return 2 * I * I * F > COUNT_MIN_FLOPS


def mix_route(I: int, nnz: int, x_finite: bool) -> str:
    """"sparse" or "dense" for an (I, I) M with ``nnz`` nonzeros."""
    return "sparse" if x_finite and nnz * SPARSE_DENSITY_INV <= I * I else "dense"


def _count(name, M, X):
    """(nnz, x_finite, row_ptr) from the count kernels and one readback."""
    I, F = X.shape
    counts = torch.empty(I, dtype=torch.int32, device=X.device)
    row_ptr = torch.empty(I + 1, dtype=torch.int64, device=X.device)
    status = torch.zeros(2, dtype=torch.int64, device=X.device)
    build.launch(name, X.device, "gossip_mix_count_launch", M.data_ptr(), X.data_ptr(), I, F,
                 counts.data_ptr(), row_ptr.data_ptr(), status.data_ptr())
    nnz, nonfinite = status.tolist()
    return nnz, not nonfinite, row_ptr


def _sparse_product(name, M, X, Y, nnz: int, row_ptr) -> None:
    I, F = X.shape
    col = torch.empty(max(nnz, 1), dtype=torch.int32, device=X.device)
    val = torch.empty(max(nnz, 1), dtype=torch.float32, device=X.device)
    build.launch(name, X.device, "gossip_mix_sparse_launch", M.data_ptr(), X.data_ptr(),
                 Y.data_ptr(), I, F, row_ptr.data_ptr(), col.data_ptr(), val.data_ptr())


def _dense_product(name, M, X, Y) -> None:
    I, F = X.shape
    build.launch(name, X.device, "gossip_mix_dense_launch", M.data_ptr(), X.data_ptr(),
                 Y.data_ptr(), I, F)


def mix_on_route(M: torch.Tensor, X: torch.Tensor, route: str) -> torch.Tensor:
    """Y = M @ X on the card through the given route, whatever M's density
    (the sparse route still needs finite X for the plain product's bits).
    For holding the two routes against each other; counts no launch."""
    name = "gossip_mix_op"
    I, F = X.shape
    build.require_contiguous(name, M=M, X=X)
    Y = torch.empty((I, F), dtype=torch.float32, device=X.device)
    if route == "sparse":
        nnz, _, row_ptr = _count(name, M, X)
        _sparse_product(name, M, X, Y, nnz, row_ptr)
    elif route == "dense":
        _dense_product(name, M, X, Y)
    else:
        raise ValueError(f"{name}: route {route!r} (sparse or dense)")
    return Y


def gossip_mix_op(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """M: (I, I); X: (I, F). Returns Y = M @ X, (I, F) f32. Inputs of
    another floating type (bf16, f16, f64) are cast to f32 first, as the
    reference's wrapper does (`ops.py:133-134`).

    CPU tensors run `ref.gossip_mix_ref`; CUDA tensors launch the kernels
    of one route (and count one in ``gossip_mix_op.launches``; the route
    lands in ``gossip_mix_op.last_route``) or raise."""
    name = "gossip_mix_op"
    I, F = X.shape
    build.require_shape(name, "M", M, (I, I))
    for arg, t in (("M", M), ("X", X)):
        if not t.is_floating_point():
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected a floating type")
    if not build.on_card(name, M, X):
        return ref.gossip_mix_ref(M.float(), X.float())
    if I > _MAX_ROWS:
        raise ValueError(f"{name}: I={I} above the kernel's {_MAX_ROWS} rows")
    M, X = M.float(), X.float()
    build.require_contiguous(name, M=M, X=X)
    Y = torch.empty((I, F), dtype=torch.float32, device=X.device)
    if I and F:
        route = "dense"
        if counts_needed(I, F):
            nnz, x_finite, row_ptr = _count(name, M, X)
            route = mix_route(I, nnz, x_finite)
        if route == "sparse":
            _sparse_product(name, M, X, Y, nnz, row_ptr)
        else:
            _dense_product(name, M, X, Y)
        gossip_mix_op.launches += 1
        gossip_mix_op.last_route = route
    return Y


gossip_mix_op.launches = 0
gossip_mix_op.last_route = None
