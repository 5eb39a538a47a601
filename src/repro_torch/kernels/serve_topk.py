"""Geo-pruned serving kernel: scores over pre-gathered candidate windows,
pad/seen masking and a running top-k carrying global item ids — port of
`_serve_topk_window_kernel` / `serve_topk_window_kernel_call`
(`src/repro/kernels/serve_topk.py:122-181`) behind `ops.serve_topk_window`
(`src/repro/kernels/ops.py:190-219`).

The public layout is the reference's: ``Vw`` is (R, Cw, K). The TPU's
K-major transpose and 128-lane padding are not copied; the CUDA kernel
(``csrc/serve_topk.cu``) reads the window as it is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

TOPK_MAX = 16   # csrc/topk.cuh TOPK_MAX


def serve_topk_window(U: torch.Tensor, Vw: torch.Tensor, cand: torch.Tensor,
                      seen_w: torch.Tensor, k: int):
    """U: (R, K) f32; Vw: (R, Cw, K) f32 item factors at the ``cand`` ids;
    cand: (R, Cw) int32 ascending item ids, -1 padded; seen_w: (R, Cw)
    int8/bool aligned to ``cand``. Returns (vals (R, k) f32, idx (R, k)
    int32 global item ids), ``(NEG_INF, -1)`` in unfilled slots.

    CPU tensors run `ref.serve_topk_window_ref`; CUDA tensors launch the
    kernel (and count one in ``serve_topk_window.launches``) or raise."""
    name = "serve_topk_window"
    R, K = U.shape
    Cw = cand.shape[1]
    build.require_shape(name, "Vw", Vw, (R, Cw, K))
    build.require_shape(name, "cand", cand, (R, Cw))
    build.require_shape(name, "seen_w", seen_w, (R, Cw))
    build.require_dtype(name, "U", U, torch.float32)
    build.require_dtype(name, "Vw", Vw, torch.float32)
    build.require_dtype(name, "cand", cand, torch.int32)
    build.require_dtype(name, "seen_w", seen_w, torch.int8, torch.bool)
    if not 0 < k <= TOPK_MAX:
        raise ValueError(f"{name}: k={k} outside 1..{TOPK_MAX}")
    if not build.on_card(name, U, Vw, cand, seen_w):
        return ref.serve_topk_window_ref(U, Vw, cand, seen_w, k)
    build.require_contiguous(name, U=U, Vw=Vw, cand=cand, seen_w=seen_w)
    vals = torch.empty((R, k), dtype=torch.float32, device=U.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=U.device)
    if R:
        build.launch(name, U.device, "serve_topk_window_launch",
                     U.data_ptr(), Vw.data_ptr(), cand.data_ptr(),
                     seen_w.view(torch.int8).data_ptr(), vals.data_ptr(), idx.data_ptr(),
                     R, Cw, K, k)
        serve_topk_window.launches += 1
    return vals, idx


serve_topk_window.launches = 0
