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
pad. Their launch layouts are chosen here, on the host (`peruser_slots`,
`shared_layout`), and handed to the C launch as arguments.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.serve_topk import MERGE_SCRATCH_BYTES, SMEM_BYTES, TOPK_MAX, slots_for

PERUSER_THREADS = 256   # csrc/topk_scores.cu kDenseThreads
MANY_THREADS = 512      # kManyThreads: 16 warps a block, one block an SM
USERS_PER_WARP = 2      # kUsersPerWarp
FEW_MAX_WARPS = 16      # csrc/topk_scores.cu kFewMaxThreads / 32
FEW_CHUNK = 128         # kChunk: items of a chunk, 4 a lane
FEW_GROUP = 2           # kGroup: the most chunks a warp copies at a time
H100_SMS = 132


def peruser_slots(J: int, k: int) -> int:
    """Kernel 2's lane list size: a block of 256 threads scans J items."""
    return slots_for(k, max(1, -(-J // PERUSER_THREADS)))


def shared_layout(R: int, J: int, K: int, k: int, n_sms: int = H100_SMS) -> dict:
    """Kernel 4's launch layout for R users over J items of K factors.

    At or above ``n_sms`` users (a block an SM) the ``many`` form:
    persistent blocks of 16 warps, each warp 2 users at a time, V staged
    K-major into shared memory in tiles of ``tile`` items (a multiple of 4)
    when it does not fit beside the merge scratch. Below, the few-users
    form: a block of ``threads`` per user (up to 16 warps), each warp
    copying ``tile`` (2, or 1 for wide rows) 128-item chunks of V at a time
    into its own slice of shared memory. Also the lanes' list size
    ``slots``, ``blocks`` and the block's shared memory."""
    room = SMEM_BYTES - MERGE_SCRATCH_BYTES
    if R >= n_sms:
        j_tile = min(max(-(-J // 4) * 4, 4), room // (4 * K) // 4 * 4)   # a multiple of 4
        if j_tile < 4:
            raise ValueError(f"recommend_topk: K={K} too wide to stage 4 items "
                             f"in {room} bytes of shared memory")
        tiles = -(-R // USERS_PER_WARP)
        return dict(many=True, threads=MANY_THREADS,
                    blocks=min(n_sms, -(-tiles // (MANY_THREADS // 32))),
                    slots=slots_for(k, max(1, 4 * -(-J // 128))), tile=j_tile,
                    smem_bytes=4 * K * j_tile + MERGE_SCRATCH_BYTES)
    chunk_bytes = 4 * K * FEW_CHUNK
    group = min(FEW_GROUP, room // chunk_bytes)
    if group < 1:
        raise ValueError(f"recommend_topk: K={K} too wide for a {FEW_CHUNK}-item chunk "
                         f"in {room} bytes of shared memory")
    warps = min(FEW_MAX_WARPS, room // (chunk_bytes * group),
                max(1, -(-J // (FEW_CHUNK * group))))
    return dict(many=False, threads=32 * warps, blocks=R, slots=few_slots(J, warps, group, k),
                tile=group, smem_bytes=chunk_bytes * group * warps + MERGE_SCRATCH_BYTES)


def few_slots(J: int, warps: int, group: int, k: int) -> int:
    """The few-users form's lane list size: warp w takes the groups of
    ``group`` 128-item chunks w, w + warps, ..., 4 items of each chunk a
    lane."""
    groups = -(-J // (FEW_CHUNK * group))
    return slots_for(k, max(1, 4 * group * -(-groups // warps)))


@functools.cache
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
                     vals.data_ptr(), idx.data_ptr(), R, J, K, k, peruser_slots(J, k))
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
    vals, idx = shared_on_layout(U, V, mask, k, shared_layout(R, J, K, k, _n_sms(U.device.index)))
    if R:
        recommend_topk.launches += 1
    return vals, idx


recommend_topk.launches = 0


def shared_on_layout(U, V, mask, k: int, layout: dict, merge: bool = True):
    """Kernel 4 on the card with the given layout (`shared_layout`'s
    keys), the inputs already checked. ``merge=False`` scores without
    merging: the outputs then hold list checksums, not a slate (a timing
    form). For the public wrapper, and for timing layouts against each
    other; counts no launch."""
    R, K = U.shape
    J = V.shape[0]
    vals = torch.empty((R, k), dtype=torch.float32, device=U.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=U.device)
    if R:
        build.launch("recommend_topk", U.device, "topk_shared_launch",
                     U.data_ptr(), V.data_ptr(), mask.view(torch.int8).data_ptr(),
                     vals.data_ptr(), idx.data_ptr(), R, J, K, k, int(layout["many"]),
                     layout["threads"], layout["blocks"], layout["slots"], layout["tile"],
                     int(merge))
    return vals, idx
