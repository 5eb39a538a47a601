"""Dense top-k serving kernels: scores over all J items, train mask,
running top-k — port of `src/repro/kernels/topk_scores.py`.

- `recommend_topk_peruser`: each user scores their own item factors (the
  DMF layout) — `_topk_peruser_kernel` with its `_merge_tile_topk` carry
  (:23-88, 121-150) behind `ops.recommend_topk_peruser`
  (`src/repro/kernels/ops.py:250-273`). V rows are (R, J, K).
- `recommend_topk`: every user scores one shared V (J, K), the centralized
  baselines' layout — `_topk_kernel` (:51-65, 91-118) behind
  `ops.recommend_topk` (`ops.py:140-155`).

Both CUDA kernels (``csrc/topk_scores.cu``) mask the ragged J edge
themselves, where the TPU wrappers padded J to 128 or 256 and masked the
pad.
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


def recommend_topk(U: torch.Tensor, V: torch.Tensor, mask: torch.Tensor, k: int):
    """U: (R, K) f32; V: (J, K) f32 item factors shared by every user;
    mask: (R, J) int8/bool, nonzero = seen. Returns (vals (R, k) f32,
    idx (R, k) int32), ``(NEG_INF, -1)`` in unfilled slots.

    CPU tensors run `ref.topk_scores_ref`; CUDA tensors launch the kernel
    (and count one in ``recommend_topk.launches``) or raise."""
    name = "recommend_topk"
    R, K = U.shape
    J = V.shape[0]
    build.require_shape(name, "V", V, (J, K))
    build.require_shape(name, "mask", mask, (R, J))
    build.require_dtype(name, "U", U, torch.float32)
    build.require_dtype(name, "V", V, torch.float32)
    build.require_dtype(name, "mask", mask, torch.int8, torch.bool)
    if not 0 < k <= TOPK_MAX:
        raise ValueError(f"{name}: k={k} outside 1..{TOPK_MAX}")
    if not build.on_card(name, U, V, mask):
        return ref.topk_scores_ref(U, V, mask, k)
    build.require_contiguous(name, U=U, V=V, mask=mask)
    vals = torch.empty((R, k), dtype=torch.float32, device=U.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=U.device)
    if R:
        build.launch(name, U.device, "topk_shared_launch",
                     U.data_ptr(), V.data_ptr(), mask.view(torch.int8).data_ptr(),
                     vals.data_ptr(), idx.data_ptr(), R, J, K, k)
        recommend_topk.launches += 1
    return vals, idx


recommend_topk.launches = 0
