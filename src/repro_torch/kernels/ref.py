"""Plain PyTorch versions of the port's kernels — port of
`src/repro/kernels/ref.py` (`dmf_grads_ref` :8-18, `dmf_fused_step_ref`,
`topk_scores_peruser_ref`, `serve_topk_ref` :48-67, `serve_topk_window_ref`,
`masked_topk_finalize`, `NEG_INF`, `dp_clip_noise_ref` :91-108,
`gossip_mix_ref` :111-114, `topk_scores_ref` :117-123) plus `dmf_fused_step_dp_ref`, the
plain form of `_dmf_fused_step_dp_kernel`, and
`serve_topk_window_quant_ref`, the plain form of
`_serve_topk_window_quant_kernel`, `serve_topk_tiled_quant_ref`, the
same on windows gathered from the tiled store, and `serve_topk_rows_ref`,
the window form on windows gathered from the serving engine's state. The plain noise stream is
`dp_noise.gauss_counter_ref`.

Each kernel wrapper runs these on CPU tensors, and `chip_smoke.py` holds
each CUDA kernel against them on the card. They run on any device.

Top-k contract, shared with the CUDA kernels and the reference's Pallas
kernels: order by (score descending, item id ascending); a masked
candidate never enters; unfilled slots are ``(NEG_INF, -1)``. The lowest-id
tie-break comes from ``torch.sort(descending=True, stable=True)`` over
positions in ascending id order — ``torch.topk`` documents no tie order.
"""
from __future__ import annotations

import contextlib

import torch

NEG_INF = -1e30   # the dead-slot sentinel value of every top-k kernel


def masked_topk_finalize(vals: torch.Tensor, idx: torch.Tensor):
    """Slots whose score is masked out (≤ NEG_INF, incl. -inf) become
    ``(NEG_INF, -1)``."""
    dead = vals <= NEG_INF
    return vals.masked_fill(dead, NEG_INF), idx.masked_fill(dead, -1)


def _topk_positions(scores: torch.Tensor, k: int):
    """(vals, positions) of the k best columns per row, ties to the lowest
    position; rows shorter than k are padded with NEG_INF columns."""
    n = scores.shape[1]
    if n < k:
        pad = scores.new_full((scores.shape[0], k - n), NEG_INF)
        scores = torch.cat([scores, pad], dim=1)
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k].clamp_max(max(n - 1, 0))


def serve_topk_window_ref(U, Vw, cand, seen_w, k: int):
    """Geo-pruned serving over pre-gathered candidate windows.

    U: (R, K) f32; Vw: (R, Cw, K) f32 item factors at the ``cand`` ids;
    cand: (R, Cw) int32 ascending item ids, -1 padded; seen_w: (R, Cw)
    bool/int8 seen bits aligned to ``cand``. Returns (vals (R, k) f32,
    idx (R, k) int32 global item ids)."""
    scores = (U[:, None, :] * Vw).sum(-1)
    scores = scores.masked_fill((cand < 0) | (seen_w != 0), NEG_INF)
    vals, pos = _topk_positions(scores, k)
    idx = torch.gather(cand.clamp_min(0), 1, pos).to(torch.int32)
    return masked_topk_finalize(vals, idx)


def serve_topk_ref(U, V, cand, seen, k: int):
    """Geo-pruned serving over whole per-request item slabs: dense scores
    over all J items, masked to the request's candidate ids and to
    ``seen == 0``.

    U: (R, K) f32; V: (R, J, K) f32; cand: (R, Cw) int32 ascending item
    ids, -1 padded (an id ≥ J is no candidate either); seen: (R, J)
    bool/int8. Returns (vals (R, k) f32, idx (R, k) int32 global item
    ids)."""
    R, J = V.shape[0], V.shape[1]
    scores = (U[:, None, :] * V).sum(-1)
    elig = torch.zeros((R, J), dtype=torch.bool, device=V.device)
    rows, cols = torch.nonzero((cand >= 0) & (cand < J), as_tuple=True)
    elig[rows, cand[rows, cols].long()] = True
    scores = scores.masked_fill(~elig | (seen != 0), NEG_INF)
    vals, pos = _topk_positions(scores, k)
    return masked_topk_finalize(vals, pos.to(torch.int32))


def serve_topk_window_quant_ref(U, Vq, scale, cand, seen_w, k: int):
    """`serve_topk_window_ref` on dequantized windows: Vq (R, Cw, K) int8
    codes or bf16 factors, times the per-request f32 ``scale`` (R,) (1 for
    bf16)."""
    return serve_topk_window_ref(U, Vq.float() * scale[:, None, None], cand, seen_w, k)


def serve_topk_tiled_quant_ref(ids, U, Vq, scale, user_bucket, bucket_items, seen, k: int):
    """`serve_topk_window_quant_ref` on the windows of users ``ids`` (R,)
    gathered from the tiled store: U (I, K), Vq (I, cap, K), scale (I,) or
    None (1), seen (I, cap), candidates ``bucket_items[user_bucket[ids]]``."""
    sc = (torch.ones(ids.shape[0], dtype=torch.float32, device=U.device) if scale is None
          else scale[ids])
    return serve_topk_window_quant_ref(U[ids], Vq[ids], sc, bucket_items[user_bucket[ids]],
                                       seen[ids], k)


def serve_topk_rows_ref(ids, U, V, seen, user_bucket, bucket_items, k: int, Q=None):
    """`serve_topk_window_ref` on the windows of users ``ids`` (R,)
    gathered from the serving engine's state: U (I, K), V (I, J, K) (with
    ``Q`` (I, J, K), the window is the gathered V plus the gathered Q),
    seen (I, J), candidates ``bucket_items[user_bucket[ids]]``, where an id
    ≥ J is no candidate."""
    cand = bucket_items[user_bucket[ids]]
    cand = cand.masked_fill(cand >= V.shape[1], -1)
    safe = cand.clamp_min(0).long()
    rows = ids[:, None]
    vw = V[rows, safe] if Q is None else V[rows, safe] + Q[rows, safe]
    return serve_topk_window_ref(U[ids], vw, cand, seen[rows, safe], k)


def topk_scores_peruser_ref(U, V, mask, k: int):
    """Dense per-user serving: every user scores all J items with their
    own item factors. U: (R, K) f32; V: (R, J, K) f32; mask: (R, J)
    bool/int8, nonzero = seen. Returns (vals (R, k) f32, idx (R, k) int32)
    under the kernel's dead-slot contract (the reference's jnp oracle
    returns raw ``-inf`` slots instead; its kernel returns these)."""
    scores = (U[:, None, :] * V).sum(-1)
    scores = scores.masked_fill(mask != 0, NEG_INF)
    vals, pos = _topk_positions(scores, k)
    return masked_topk_finalize(vals, pos.to(torch.int32))


def dmf_grads_ref(u, p, q, r, conf, alpha, beta, gamma):
    """Confidence-weighted per-rating gradients (paper Eqs. 9-11). u/p/q:
    (B, K) f32; r/conf: (B,) f32. Returns (gu, gp, gq), each (B, K)."""
    v = p + q
    err = (conf * (r - (u * v).sum(-1)))[:, None]
    gu = -err * v + alpha * u
    gp = -err * u + beta * p
    gq = -err * u + gamma * q
    return gu, gp, gq


def dmf_fused_step_ref(u, p, q, r, conf, theta, alpha, beta, gamma):
    """Fused Alg. 1 step (paper Eqs. 9-11): lr-scaled deltas for the
    sender's u/q, the raw global-factor gradient message gp, and the batch
    loss ½·Σ c·raw². u/p/q: (B, K) f32; r/conf: (B,) f32."""
    v = p + q
    raw = r - (u * v).sum(-1)
    err = (conf * raw)[:, None]
    du = -theta * (-err * v + alpha * u)
    gp = -err * u + beta * p
    dq = -theta * (-err * u + gamma * q)
    loss = 0.5 * (conf * raw * raw).sum()
    return du, gp, dq, loss


def _clip_rows(g, clip):
    """g · min(1, clip / ‖g‖₂) per row: a zero row or clip=inf scales by
    exactly 1; a NaN ratio stays NaN, as the reference's minimum keeps it."""
    nrm = torch.sqrt((g * g).sum(-1, keepdim=True))
    return g * (clip / nrm).clamp(max=1.0)


def dmf_fused_step_dp_ref(u, p, q, r, conf, z, theta, alpha, beta, gamma, clip):
    """`dmf_fused_step_ref` with the DP mechanism on the message: gp is
    clipped per row to ``clip`` and the batch's pre-scaled noise ``z``
    (B, K) is added."""
    du, gp, dq, loss = dmf_fused_step_ref(u, p, q, r, conf, theta, alpha, beta, gamma)
    return du, _clip_rows(gp, clip) + z, dq, loss


def dp_clip_noise_ref(g, rid, seed, clip, noise_std):
    """DP message mechanism: per-row L2 clip to ``clip``, then
    ``noise_std`` times the counter-keyed draws of the rows' ``rid``.
    g: (B, K) f32; rid: (B,) int32; seed: int. ``noise_std=0`` adds
    nothing, so with clip=inf the result is g bit for bit."""
    from repro_torch.kernels.dp_noise import gauss_counter_ref
    out = _clip_rows(g, clip)
    if noise_std > 0.0:
        out = out + noise_std * gauss_counter_ref(seed, rid, g.shape[1])
    return out


@contextlib.contextmanager
def fp32_matmul():
    """Full fp32 products on CUDA for the block (TF32 off), whatever the
    process's setting; restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def gossip_mix_ref(M, X):
    """Propagation mixing Y = M @ X: the (I, I) walk matrix times the
    flattened learner state (I, F), Alg. 1 line 15 over every receiver.
    fp32, TF32 off."""
    with fp32_matmul():
        return M @ X


def topk_scores_ref(U, V, mask, k: int):
    """Masked top-k over one shared item matrix: U (R, K) f32, V (J, K)
    f32, mask (R, J) bool/int8, nonzero = seen. Returns (vals (R, k) f32,
    idx (R, k) int32) under the kernel's dead-slot contract (the
    reference's jnp oracle returns raw ``-inf`` slots; its kernel returns
    these). fp32 scores, TF32 off."""
    with fp32_matmul():
        scores = U @ V.T
    scores = scores.masked_fill(mask != 0, NEG_INF)
    vals, pos = _topk_positions(scores, k)
    return masked_topk_finalize(vals, pos.to(torch.int32))
