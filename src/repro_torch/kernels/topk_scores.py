"""Dense per-user serving kernel: scores over all J items with each
user's own item factors, train mask, running top-k — port of
`_topk_peruser_kernel` with its `_merge_tile_topk` carry
(`src/repro/kernels/topk_scores.py:23-88, 121-150`) behind
`ops.recommend_topk_peruser` (`src/repro/kernels/ops.py:250-273`).

The public layout is the reference's: V rows are (R, J, K). The CUDA
kernel (``csrc/topk_scores.cu``) masks the ragged J edge itself, where the
TPU wrapper padded J to 128 and masked the pad.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.serve_topk import TOPK_MAX


def recommend_topk_peruser(U: torch.Tensor, V: torch.Tensor, mask: torch.Tensor, k: int):
    """U: (R, K) f32; V: (R, J, K) f32 per-user item factors; mask: (R, J)
    int8/bool, nonzero = seen. Returns (vals (R, k) f32, idx (R, k) int32),
    ``(NEG_INF, -1)`` in unfilled slots.

    CPU tensors run `ref.topk_scores_peruser_ref`; CUDA tensors launch the
    kernel (and count one in ``recommend_topk_peruser.launches``) or raise."""
    name = "recommend_topk_peruser"
    R, K = U.shape
    J = V.shape[1]
    build.require_shape(name, "V", V, (R, J, K))
    build.require_shape(name, "mask", mask, (R, J))
    build.require_dtype(name, "U", U, torch.float32)
    build.require_dtype(name, "V", V, torch.float32)
    build.require_dtype(name, "mask", mask, torch.int8, torch.bool)
    if not 0 < k <= TOPK_MAX:
        raise ValueError(f"{name}: k={k} outside 1..{TOPK_MAX}")
    if not build.on_card(name, U, V, mask):
        return ref.topk_scores_peruser_ref(U, V, mask, k)
    build.require_contiguous(name, U=U, V=V, mask=mask)
    vals = torch.empty((R, k), dtype=torch.float32, device=U.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=U.device)
    if R:
        build.launch(name, U.device, "topk_peruser_launch",
                     U.data_ptr(), V.data_ptr(), mask.view(torch.int8).data_ptr(),
                     vals.data_ptr(), idx.data_ptr(), R, J, K, k)
        recommend_topk_peruser.launches += 1
    return vals, idx


recommend_topk_peruser.launches = 0
