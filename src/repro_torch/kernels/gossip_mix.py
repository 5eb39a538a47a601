"""Random-walk propagation mixing Y = M @ X — port of `_mix_kernel` /
`gossip_mix_kernel_call` (`src/repro/kernels/gossip_mix.py:22-55`) behind
`ops.gossip_mix_op` (`src/repro/kernels/ops.py:130-137`).

Alg. 1 lines 13-15 vectorized: M (I, I) is the walk-propagation matrix
(`graph.walk_propagation_matrix`), X (I, F) the flattened per-learner
global state (or a block of gradient messages). The CUDA kernel
(``csrc/gossip_mix.cu``) is a register-tiled fp32 SGEMM on the CUDA cores;
it predicates the ragged I and F edges, where the TPU wrapper padded both
to 128.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_MAX_ROWS = 65_535 * 128   # the kernel's grid.y limit times its 128-row tile


def gossip_mix_op(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """M: (I, I); X: (I, F). Returns Y = M @ X, (I, F) f32. Inputs of
    another floating type (bf16, f16, f64) are cast to f32 first, as the
    reference's wrapper does (`ops.py:133-134`).

    CPU tensors run `ref.gossip_mix_ref`; CUDA tensors launch the kernel
    (and count one in ``gossip_mix_op.launches``) or raise."""
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
        build.launch(name, X.device, "gossip_mix_launch",
                     M.data_ptr(), X.data_ptr(), Y.data_ptr(), I, F)
        gossip_mix_op.launches += 1
    return Y


gossip_mix_op.launches = 0
