"""Dense top-k serving kernels: scores over all J items, train mask,
running top-k — port of `src/repro/kernels/topk_scores.py`.

- `recommend_topk_peruser`: each user scores their own item factors (the
  DMF layout) — `_topk_peruser_kernel` with its `_merge_tile_topk` carry
  (:23-88, 121-150) behind `ops.recommend_topk_peruser`
  (`src/repro/kernels/ops.py:250-273`). V rows are (R, J, K), or read in
  place: rows ``rows[r]`` of V (and of Q, v = p + q) and of the mask.
- `recommend_topk`: every user scores one shared V (J, K), the centralized
  baselines' layout — `_topk_kernel` (:51-65, 91-118) behind
  `ops.recommend_topk` (`ops.py:140-155`).

Both CUDA kernels (``csrc/topk_scores.cu``) mask the ragged J edge
themselves, where the TPU wrappers padded J to 128 or 256 and masked the
pad. Their launch layouts are chosen here, on the host (`peruser_layout`,
`shared_layout`), and handed to the C launch as arguments.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.serve_topk import MERGE_SCRATCH_BYTES, SMEM_BYTES, TOPK_MAX, slots_for

MANY_THREADS = 512      # kManyThreads: 16 warps a block, one block an SM
USERS_PER_WARP = 2      # kUsersPerWarp
FEW_MAX_WARPS = 16      # csrc/topk_scores.cu kFewMaxThreads / 32 (and MERGE_WARPS)
CHUNK = 128             # kChunk: items of a streamed chunk, 4 a lane
MASK_BYTES = 144        # kMaskBytes: a chunk's mask window
MAX_CLUSTER = 4         # kMaxCluster
RING_STAGES = 2         # chunks a warp's ring holds, as the host chooses
H100_SMS = 132


def stage_bytes(K: int, fused: bool = False) -> int:
    """Shared memory of one ring stage (csrc/topk_scores.cu
    ``stage_floats``): a chunk's V rows (and Q rows), each with 4 floats
    of alignment room, and its mask window."""
    return 4 * (CHUNK * K + 4) * (2 if fused else 1) + MASK_BYTES


def rows_per_lane(J: int, cluster: int, warps: int) -> int:
    """The most items one lane of the rows body scores: ceil(J / 128)
    chunks over ``cluster`` blocks in contiguous shares, a block's over its
    warps in turn, 4 items of a chunk a lane (``rows_per_lane``)."""
    chunks = -(-J // CHUNK)
    per_block = -(-chunks // cluster)
    return max(1, 4 * -(-per_block // warps))


def peruser_layout(R: int, J: int, K: int, k: int, n_sms: int = H100_SMS,
                   fused: bool = False) -> dict:
    """Kernel 2's launch layout for R requests over J items of K factors
    (``fused``: through P and Q, two chunks a stage).

    Below ``n_sms`` requests (few users) each user's chunks are split over
    a thread block cluster of ``cluster`` blocks (2 from a quarter of the
    SMs up, else 4), ``warps`` warps a block (16 in all, none without a
    chunk). At or above (many users) a block of 4 warps a user, so that
    several blocks share an SM (5, or 2 through P and Q). A ring of 2
    chunks a warp either way. Also the lanes' list size ``slots``,
    ``blocks``, ``threads`` and the block's shared memory."""
    chunks = max(1, -(-J // CHUNK))
    if R >= n_sms:
        cluster, warps = 1, 4
    else:
        cluster = min(2 if 4 * R >= n_sms else MAX_CLUSTER, chunks)
        warps = min(FEW_MAX_WARPS // cluster, -(-chunks // cluster))
    return rows_layout(J, K, k, cluster, warps, RING_STAGES, fused, R)


def rows_layout(J: int, K: int, k: int, cluster: int, warps: int, stages: int,
                fused: bool = False, R: int = 1) -> dict:
    """A layout of the rows body (kernel 2, and kernel 4's few-users form)
    with the given cluster, warps and stages, cut to what fits: fewer
    stages, then fewer warps, while a block passes its shared memory."""
    room = SMEM_BYTES - MERGE_SCRATCH_BYTES
    per_stage = stage_bytes(K, fused)
    if per_stage > room:
        raise ValueError(f"top-k rows body: K={K} too wide for a {CHUNK}-item chunk "
                         f"in {room} bytes of shared memory")
    while stages > 1 and warps * stages * per_stage > room:
        stages -= 1
    warps = max(1, min(warps, room // (stages * per_stage)))
    return dict(cluster=cluster, warps=warps, stages=stages, threads=32 * warps,
                blocks=R * cluster, slots=slots_for(k, rows_per_lane(J, cluster, warps)),
                smem_bytes=warps * stages * per_stage + MERGE_SCRATCH_BYTES)


def shared_layout(R: int, J: int, K: int, k: int, n_sms: int = H100_SMS) -> dict:
    """Kernel 4's launch layout for R users over J items of K factors.

    At or above ``n_sms`` users (a block an SM) the ``many`` form:
    persistent blocks of 16 warps, each warp 2 users at a time, V staged
    K-major into shared memory in tiles of ``tile`` items (a multiple of 4)
    when it does not fit beside the merge scratch. Below, the few-users
    form, kernel 2's body and layout (`peruser_layout`) on the shared V:
    each user's 128-item chunks over a cluster of ``cluster`` blocks of
    ``threads``, each warp streaming its chunks through a ring of ``tile``
    stages. Also the lanes' list size ``slots``, ``blocks`` and the
    block's shared memory."""
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
    lay = peruser_layout(R, J, K, k, n_sms)
    return dict(many=False, threads=lay["threads"], blocks=lay["blocks"], slots=lay["slots"],
                tile=lay["stages"], cluster=lay["cluster"], smem_bytes=lay["smem_bytes"])


@functools.cache
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_rows(name: str, U, V, mask, Q, rows) -> None:
    """Shapes and types of kernel 2's inputs: U (R, K); V and Q (N, J, K);
    mask (N, J); rows (R,) int64, or N = R without rows."""
    R, K = U.shape
    N, J = V.shape[0], V.shape[1]
    if rows is None:
        build.require_shape(name, "V", V, (R, J, K))
    else:
        build.require_dtype(name, "rows", rows, torch.int64)
        build.require_shape(name, "rows", rows, (R,))
        build.require_shape(name, "V", V, (N, J, K))
    build.require_shape(name, "mask", mask, (N, J))
    build.require_dtype(name, "U", U, torch.float32)
    build.require_dtype(name, "V", V, torch.float32)
    build.require_dtype(name, "mask", mask, torch.int8, torch.bool)
    if Q is not None:
        build.require_shape(name, "Q", Q, tuple(V.shape))
        build.require_dtype(name, "Q", Q, torch.float32)


def recommend_topk_peruser(U: torch.Tensor, V: torch.Tensor, mask: torch.Tensor, k: int, *,
                           Q: torch.Tensor | None = None, rows: torch.Tensor | None = None):
    """U: (R, K) f32; V: (R, J, K) f32 per-user item factors; mask: (R, J)
    int8/bool, nonzero = seen. Returns (vals (R, k) f32, idx (R, k) int32),
    ``(NEG_INF, -1)`` in unfilled slots.

    Rows in place: with ``rows`` ((R,) int64), request r scores row
    ``rows[r]`` of V (N, J, K) over row ``rows[r]`` of the mask (N, J);
    with ``Q`` (V's shape), it scores v = V row + Q row (one fp32 add, the
    bits of ``V + Q``). Either way the result is that of the call on the
    materialized ``V[rows] + Q[rows]``, ``mask[rows]``.

    CPU tensors run `ref.topk_scores_peruser_ref` on those rows; CUDA
    tensors launch the kernel (and count one in
    ``recommend_topk_peruser.launches``) or raise. A row id outside
    [0, N) raises on the CPU and traps the kernel on the card."""
    name = "recommend_topk_peruser"
    _check_rows(name, U, V, mask, Q, rows)
    if not 0 < k <= TOPK_MAX:
        raise ValueError(f"{name}: k={k} outside 1..{TOPK_MAX}")
    tensors = [t for t in (U, V, mask, Q, rows) if t is not None]
    if not build.on_card(name, *tensors):
        if rows is not None:
            if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= V.shape[0]):
                raise IndexError(f"{name}: a row id outside [0, {V.shape[0]})")
            V, mask, Q = V[rows], mask[rows], None if Q is None else Q[rows]
        return ref.topk_scores_peruser_ref(U, V if Q is None else V + Q, mask, k)
    R, K = U.shape
    layout = peruser_layout(R, V.shape[1], K, k, _n_sms(U.device.index), fused=Q is not None)
    vals, idx = peruser_on_layout(U, V, mask, k, layout, Q=Q, rows=rows)
    if R:
        recommend_topk_peruser.launches += 1
    return vals, idx


recommend_topk_peruser.launches = 0


def peruser_on_layout(U, V, mask, k: int, layout: dict, *, Q=None, rows=None,
                      merge: bool = True):
    """Kernel 2 on the card with the given layout (`peruser_layout`'s
    keys), the inputs already checked. ``merge=False`` scores without
    merging: the outputs then hold list checksums, not a slate (a timing
    form). For the public wrapper, and for timing layouts against each
    other; counts no launch."""
    build.require_contiguous("recommend_topk_peruser", U=U, V=V, mask=mask,
                             **({} if Q is None else {"Q": Q}),
                             **({} if rows is None else {"rows": rows}))
    R, K = U.shape
    vals = torch.empty((R, k), dtype=torch.float32, device=U.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=U.device)
    if R:
        build.launch("recommend_topk_peruser", U.device, "topk_peruser_launch",
                     U.data_ptr(), V.data_ptr(), 0 if Q is None else Q.data_ptr(),
                     0 if rows is None else rows.data_ptr(), mask.view(torch.int8).data_ptr(),
                     vals.data_ptr(), idx.data_ptr(), V.shape[0], R, V.shape[1], K, k,
                     layout["cluster"], layout["warps"], layout["stages"], layout["slots"],
                     int(merge))
    return vals, idx


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
                     layout.get("cluster", 1), int(merge))
    return vals, idx
