"""Geo-pruned serving kernels: scores over each request's candidate ids,
pad/seen masking and a running top-k carrying global item ids — port of
the three kernel families of `src/repro/kernels/serve_topk.py` behind
their `src/repro/kernels/ops.py` wrappers:

* `serve_topk_window` — `_serve_topk_window_kernel` (:122-181) behind
  `ops.serve_topk_window` (:190-219): pre-gathered fp32 windows;
* `serve_topk` — `_serve_topk_kernel` (:64-119) behind `ops.serve_topk`
  (:158-187): the candidates gathered out of whole item slabs inside the
  kernel, the staging reference of the tiled path;
* `serve_topk_rows` — the same kernel reading the serving engine's state
  in place (user ids, U, V or P and Q, seen, the index's user buckets and
  bucket items), as the reference's compiled design keeps V in HBM and
  reads only the candidate rows (`ops.serve_topk`'s docstring): the
  engine's pruned dispatch, one launch and no gathered copy;
* `serve_topk_window_quant` — `_serve_topk_window_quant_kernel`
  (:184-250) behind `ops.serve_topk_window_quant` (:222-247): windows as
  int8 codes times a per-request scale, or as bf16;
* `serve_topk_tiled_quant` — the same kernel reading the tiled store in
  place (user ids, the store's U, codes, scales and seen bits, the index's
  user buckets and bucket items), with no gathered copy: the tiled
  engine's int8/bf16 dispatch.

The public layouts are the reference's: windows (R, Cw, K), slabs
(R, J, K), the store (I, cap, K). The TPU's K-major transpose and 128-lane padding are not
copied; one CUDA kernel body (``csrc/serve_topk.cu``) reads each form as
it is. The slab forms and the quant forms equal the fp32 window form bit
for bit on windows gathered from the same rows (with Q, on the gathered
``P + Q``), resp. on ``codes.float() * scale``.

The launch layout (warps a request, requests a block, the lanes' list
size) is chosen here, on the host, by `window_layout`, and handed to the
C launch as arguments.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

TOPK_MAX = 16   # csrc/topk.cuh TOPK_MAX
SMEM_BYTES = 232_448        # the shared memory an H100 block can have (227 KB)
MERGE_SCRATCH_BYTES = 16 * TOPK_MAX * 8   # csrc/topk.cuh MergeScratch, static
MAX_WARPS = 16              # csrc/serve_topk.cu kMaxThreads / 32
CANDIDATES_PER_LANE = 4     # a request takes ceil(Cw / 128) warps
WARPS_PER_BLOCK = 4         # one-warp requests share a block four at a time


def slots_for(k: int, per_lane: int) -> int:
    """The lane list size (4, 8 or 16) for k from lanes that score at most
    ``per_lane`` candidates each: the smallest that holds min(k, per_lane)
    (csrc/topk.cuh ``slots_fit``)."""
    n = min(k, per_lane)
    return 4 if n <= 4 else 8 if n <= 8 else 16


def window_layout(R: int, Cw: int, k: int) -> dict:
    """The launch layout of kernels 1, 5 (both forms) and 6 for R requests of Cw
    candidates: ``warps`` a request (one for Cw ≤ 128, else ceil(Cw / 128),
    at most 16), ``rpb`` requests a block, ``slots`` in a lane's list,
    ``blocks``, ``threads`` a block and its shared memory."""
    warps = min(MAX_WARPS, max(1, -(-Cw // (32 * CANDIDATES_PER_LANE))))
    rpb = max(1, WARPS_PER_BLOCK // warps)
    per_lane = max(1, -(-Cw // (32 * warps)))
    return dict(warps=warps, rpb=rpb, slots=slots_for(k, per_lane), blocks=-(-R // rpb),
                threads=32 * warps * rpb, smem_bytes=MERGE_SCRATCH_BYTES)


def _layout_args(layout: dict, merge: bool) -> tuple:
    return layout["warps"], layout["rpb"], layout["slots"], int(merge)


def _check_k(name: str, k: int) -> None:
    if not 0 < k <= TOPK_MAX:
        raise ValueError(f"{name}: k={k} outside 1..{TOPK_MAX}")


def _outputs(R: int, k: int, device: torch.device):
    return (torch.empty((R, k), dtype=torch.float32, device=device),
            torch.empty((R, k), dtype=torch.int32, device=device))


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
    _check_k(name, k)
    if not build.on_card(name, U, Vw, cand, seen_w):
        return ref.serve_topk_window_ref(U, Vw, cand, seen_w, k)
    build.require_contiguous(name, U=U, Vw=Vw, cand=cand, seen_w=seen_w)
    vals, idx = window_on_layout(U, Vw, cand, seen_w, k, window_layout(R, Cw, k))
    if R:
        serve_topk_window.launches += 1
    return vals, idx


serve_topk_window.launches = 0


def window_on_layout(U, Vw, cand, seen_w, k: int, layout: dict, merge: bool = True):
    """Kernel 1 on the card with the given layout (`window_layout`'s
    keys), the inputs already checked. ``merge=False`` scores without
    merging: the outputs then hold list checksums, not a slate (a timing
    form). For the public wrapper, and for timing layouts against each
    other; counts no launch."""
    R, K = U.shape
    vals, idx = _outputs(R, k, U.device)
    if R:
        build.launch("serve_topk_window", U.device, "serve_topk_window_launch",
                     U.data_ptr(), Vw.data_ptr(), cand.data_ptr(),
                     seen_w.view(torch.int8).data_ptr(), vals.data_ptr(), idx.data_ptr(),
                     R, cand.shape[1], K, k, *_layout_args(layout, merge))
    return vals, idx


def serve_topk(U: torch.Tensor, V: torch.Tensor, cand: torch.Tensor, seen: torch.Tensor,
               k: int):
    """U: (R, K) f32; V: (R, J, K) f32 each request's whole item slab;
    cand: (R, Cw) int32 ascending item ids, -1 padded (an id ≥ J is no
    candidate and reads nothing); seen: (R, J) int8/bool. Returns (vals
    (R, k) f32, idx (R, k) int32 global item ids), ``(NEG_INF, -1)`` in
    unfilled slots.

    CPU tensors run `ref.serve_topk_ref`; CUDA tensors launch the kernel
    (and count one in ``serve_topk.launches``) or raise."""
    name = "serve_topk"
    R, K = U.shape
    J, Cw = V.shape[1], cand.shape[1]
    build.require_shape(name, "V", V, (R, J, K))
    build.require_shape(name, "cand", cand, (R, Cw))
    build.require_shape(name, "seen", seen, (R, J))
    build.require_dtype(name, "U", U, torch.float32)
    build.require_dtype(name, "V", V, torch.float32)
    build.require_dtype(name, "cand", cand, torch.int32)
    build.require_dtype(name, "seen", seen, torch.int8, torch.bool)
    _check_k(name, k)
    if not build.on_card(name, U, V, cand, seen):
        return ref.serve_topk_ref(U, V, cand, seen, k)
    build.require_contiguous(name, U=U, V=V, cand=cand, seen=seen)
    vals, idx = _outputs(R, k, U.device)
    if R:
        build.launch(name, U.device, "serve_topk_launch",
                     U.data_ptr(), V.data_ptr(), cand.data_ptr(),
                     seen.view(torch.int8).data_ptr(), vals.data_ptr(), idx.data_ptr(),
                     R, J, Cw, K, k, *_layout_args(window_layout(R, Cw, k), True))
        serve_topk.launches += 1
    return vals, idx


serve_topk.launches = 0


def serve_topk_rows(ids: torch.Tensor, U: torch.Tensor, V: torch.Tensor, seen: torch.Tensor,
                    user_bucket: torch.Tensor, bucket_items: torch.Tensor, k: int, *,
                    Q: torch.Tensor | None = None):
    """Kernel 5 reading the serving engine's state in place. ids: (R,)
    int64 user ids; U: (I, K) f32; V: (I, J, K) f32 each user's item
    factors (with ``Q``, P: the served factor is v = p + q); Q: (I, J, K)
    f32 or None; seen: (I, J) int8/bool; user_bucket: (I,) int64;
    bucket_items: (n_buckets, Cw) int32 ascending item ids, -1 padded (an
    id ≥ J is no candidate and reads nothing). Request r serves user
    ``ids[r]``: the result is that of `serve_topk_window` on the gathered
    ``U[ids]``, ``V[ids[:, None], cand]`` (plus ``Q[ids[:, None], cand]``),
    ``cand = bucket_items[user_bucket[ids]]`` and ``seen[ids[:, None],
    cand]``, bit for bit.

    CPU tensors run `ref.serve_topk_rows_ref`; CUDA tensors launch the
    kernel (and count one in ``serve_topk_rows.launches``) or raise. An id
    outside [0, I), or a user's bucket outside [0, n_buckets), raises on
    the CPU and traps the kernel on the card."""
    name = "serve_topk_rows"
    I, K = U.shape
    J, Cw = V.shape[1], bucket_items.shape[1]
    R = ids.shape[0]
    build.require_shape(name, "ids", ids, (R,))
    build.require_dtype(name, "ids", ids, torch.int64)
    build.require_shape(name, "V", V, (I, J, K))
    build.require_shape(name, "seen", seen, (I, J))
    build.require_shape(name, "user_bucket", user_bucket, (I,))
    build.require_dtype(name, "U", U, torch.float32)
    build.require_dtype(name, "V", V, torch.float32)
    build.require_dtype(name, "seen", seen, torch.int8, torch.bool)
    build.require_dtype(name, "user_bucket", user_bucket, torch.int64)
    build.require_dtype(name, "bucket_items", bucket_items, torch.int32)
    if Q is not None:
        build.require_shape(name, "Q", Q, (I, J, K))
        build.require_dtype(name, "Q", Q, torch.float32)
    _check_k(name, k)
    tensors = [t for t in (ids, U, V, Q, seen, user_bucket, bucket_items) if t is not None]
    if not build.on_card(name, *tensors):
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= I):
            raise IndexError(f"{name}: a user id outside [0, {I})")
        buckets = user_bucket[ids]
        if buckets.numel() and (int(buckets.min()) < 0
                                or int(buckets.max()) >= bucket_items.shape[0]):
            raise IndexError(f"{name}: a bucket outside [0, {bucket_items.shape[0]})")
        return ref.serve_topk_rows_ref(ids, U, V, seen, user_bucket, bucket_items, k, Q=Q)
    vals, idx = rows_on_layout(ids, U, V, seen, user_bucket, bucket_items, k,
                               window_layout(R, Cw, k), Q=Q)
    if R:
        serve_topk_rows.launches += 1
    return vals, idx


serve_topk_rows.launches = 0


def rows_on_layout(ids, U, V, seen, user_bucket, bucket_items, k: int, layout: dict,
                   merge: bool = True, Q=None):
    """`serve_topk_rows` on the card with the given layout
    (`window_layout`'s keys), the inputs already checked. ``merge=False``
    scores without merging (a timing form, as `window_on_layout`); counts
    no launch."""
    build.require_contiguous("serve_topk_rows", ids=ids, U=U, V=V, seen=seen,
                             user_bucket=user_bucket, bucket_items=bucket_items,
                             **({} if Q is None else {"Q": Q}))
    R = ids.shape[0]
    I, K = U.shape
    vals, idx = _outputs(R, k, U.device)
    if R:
        build.launch("serve_topk_rows", U.device, "serve_topk_rows_launch",
                     ids.data_ptr(), U.data_ptr(), V.data_ptr(),
                     0 if Q is None else Q.data_ptr(), seen.view(torch.int8).data_ptr(),
                     user_bucket.data_ptr(), bucket_items.data_ptr(), vals.data_ptr(),
                     idx.data_ptr(), R, I, bucket_items.shape[0], V.shape[1],
                     bucket_items.shape[1], K, k, *_layout_args(layout, merge))
    return vals, idx


def serve_topk_window_quant(U: torch.Tensor, Vq: torch.Tensor, scale: torch.Tensor,
                            cand: torch.Tensor, seen_w: torch.Tensor, k: int):
    """U: (R, K) f32; Vq: (R, Cw, K) int8 codes or bf16 factors at the
    ``cand`` ids; scale: (R,) f32 per-request dequant scale (1 for bf16);
    cand: (R, Cw) int32 ascending item ids, -1 padded; seen_w: (R, Cw)
    int8/bool aligned to ``cand``. Returns (vals (R, k) f32, idx (R, k)
    int32), ``(NEG_INF, -1)`` in unfilled slots.

    CPU tensors run `ref.serve_topk_window_quant_ref`; CUDA tensors launch
    the kernel (and count one in ``serve_topk_window_quant.launches``) or
    raise."""
    name = "serve_topk_window_quant"
    R, K = U.shape
    Cw = cand.shape[1]
    build.require_shape(name, "Vq", Vq, (R, Cw, K))
    build.require_shape(name, "scale", scale, (R,))
    build.require_shape(name, "cand", cand, (R, Cw))
    build.require_shape(name, "seen_w", seen_w, (R, Cw))
    build.require_dtype(name, "U", U, torch.float32)
    build.require_dtype(name, "Vq", Vq, torch.int8, torch.bfloat16)
    build.require_dtype(name, "scale", scale, torch.float32)
    build.require_dtype(name, "cand", cand, torch.int32)
    build.require_dtype(name, "seen_w", seen_w, torch.int8, torch.bool)
    _check_k(name, k)
    if not build.on_card(name, U, Vq, scale, cand, seen_w):
        return ref.serve_topk_window_quant_ref(U, Vq, scale, cand, seen_w, k)
    build.require_contiguous(name, U=U, Vq=Vq, scale=scale, cand=cand, seen_w=seen_w)
    vals, idx = _outputs(R, k, U.device)
    if R:
        build.launch(name, U.device, "serve_topk_window_quant_launch",
                     U.data_ptr(), Vq.data_ptr(), scale.data_ptr(), cand.data_ptr(),
                     seen_w.view(torch.int8).data_ptr(), vals.data_ptr(), idx.data_ptr(),
                     R, Cw, K, k, int(Vq.dtype == torch.bfloat16),
                     *_layout_args(window_layout(R, Cw, k), True))
        serve_topk_window_quant.launches += 1
    return vals, idx


serve_topk_window_quant.launches = 0


def serve_topk_tiled_quant(ids: torch.Tensor, U: torch.Tensor, Vq: torch.Tensor,
                           scale: torch.Tensor | None, user_bucket: torch.Tensor,
                           bucket_items: torch.Tensor, seen: torch.Tensor, k: int):
    """Kernel 6 reading the tiled store in place. ids: (R,) int64 user
    ids; U: (I, K) f32; Vq: (I, cap, K) int8 codes or bf16 factors, each
    user's window; scale: (I,) f32 per-user dequant scale, or None (1, as
    for bf16); user_bucket: (I,) int64; bucket_items: (n_buckets, cap)
    int32 ascending item ids, -1 padded; seen: (I, cap) int8/bool aligned
    to the user's bucket row. Request r serves user ``ids[r]``: the result
    is that of `serve_topk_window_quant` on the gathered ``U[ids]``,
    ``Vq[ids]``, ``scale[ids]``, ``bucket_items[user_bucket[ids]]``,
    ``seen[ids]``, bit for bit.

    CPU tensors run `ref.serve_topk_tiled_quant_ref`; CUDA tensors launch
    the kernel (and count one in ``serve_topk_tiled_quant.launches``) or
    raise. An id outside [0, I), or a user's bucket outside
    [0, n_buckets), raises on the CPU and traps the kernel on the card."""
    name = "serve_topk_tiled_quant"
    I, K = U.shape
    cap = bucket_items.shape[1]
    R = ids.shape[0]
    build.require_shape(name, "ids", ids, (R,))
    build.require_dtype(name, "ids", ids, torch.int64)
    build.require_shape(name, "Vq", Vq, (I, cap, K))
    build.require_shape(name, "user_bucket", user_bucket, (I,))
    build.require_shape(name, "seen", seen, (I, cap))
    build.require_dtype(name, "U", U, torch.float32)
    build.require_dtype(name, "Vq", Vq, torch.int8, torch.bfloat16)
    build.require_dtype(name, "user_bucket", user_bucket, torch.int64)
    build.require_dtype(name, "bucket_items", bucket_items, torch.int32)
    build.require_dtype(name, "seen", seen, torch.int8, torch.bool)
    if scale is not None:
        build.require_shape(name, "scale", scale, (I,))
        build.require_dtype(name, "scale", scale, torch.float32)
    _check_k(name, k)
    tensors = [t for t in (ids, U, Vq, scale, user_bucket, bucket_items, seen) if t is not None]
    if not build.on_card(name, *tensors):
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= I):
            raise IndexError(f"{name}: a user id outside [0, {I})")
        buckets = user_bucket[ids]
        if buckets.numel() and (int(buckets.min()) < 0
                                or int(buckets.max()) >= bucket_items.shape[0]):
            raise IndexError(f"{name}: a bucket outside [0, {bucket_items.shape[0]})")
        return ref.serve_topk_tiled_quant_ref(ids, U, Vq, scale, user_bucket, bucket_items,
                                              seen, k)
    vals, idx = tiled_quant_on_layout(ids, U, Vq, scale, user_bucket, bucket_items, seen, k,
                                      window_layout(R, cap, k))
    if R:
        serve_topk_tiled_quant.launches += 1
    return vals, idx


serve_topk_tiled_quant.launches = 0


def tiled_quant_on_layout(ids, U, Vq, scale, user_bucket, bucket_items, seen, k: int,
                          layout: dict, merge: bool = True):
    """`serve_topk_tiled_quant` on the card with the given layout
    (`window_layout`'s keys), the inputs already checked. ``merge=False``
    scores without merging (a timing form, as `window_on_layout`); counts
    no launch."""
    build.require_contiguous("serve_topk_tiled_quant", ids=ids, U=U, Vq=Vq,
                             user_bucket=user_bucket, bucket_items=bucket_items, seen=seen,
                             **({} if scale is None else {"scale": scale}))
    R = ids.shape[0]
    I, K = U.shape
    cap = bucket_items.shape[1]
    vals, idx = _outputs(R, k, U.device)
    if R:
        build.launch("serve_topk_tiled_quant", U.device, "serve_topk_tiled_quant_launch",
                     ids.data_ptr(), U.data_ptr(), Vq.data_ptr(),
                     0 if scale is None else scale.data_ptr(), seen.view(torch.int8).data_ptr(),
                     user_bucket.data_ptr(), bucket_items.data_ptr(), vals.data_ptr(),
                     idx.data_ptr(), R, I, bucket_items.shape[0], cap, K, k,
                     int(Vq.dtype == torch.bfloat16),
                     *_layout_args(layout, merge))
    return vals, idx
