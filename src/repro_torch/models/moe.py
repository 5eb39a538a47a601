"""Mixture-of-Experts FFN (DeepSeek-V2 / Jamba style: shared + routed
top-k) — port of `src/repro/models/moe.py:29-145` (`init_moe`, `_route`,
`_grouped_expert_ffn`, `moe_capacity`, `_shared_ffn`, `moe_ffn_local`).
`moe_ffn_sharded` (:147-240) needs a mesh and belongs to the sharding
slice.

Routes are grouped with a capacity-bounded stable sort and one
capacity-sized window per expert (static shapes; overflow drops, standard
capacity semantics), as in the reference:

* the sort of the (token, choice) routes by expert id is stable
  (`jnp.argsort` is), so that routes keep the token order
  ``repeat(arange(T), k)`` within an expert;
* an expert's window starts at its first route (``searchsorted``), clamped
  to ``[0, N - capacity]`` as `lax.dynamic_slice` clamps it (:103-105);
* the router's top-k takes the lowest expert id among equal
  probabilities, as `lax.top_k` does.

The reference scans the experts one at a time; the port gathers every
expert's window at once and runs the experts as one batched product, then
adds the outputs back in the same expert-major order through
`core/scatter.py::scatter_add_rows_` (deterministic on both devices).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.scatter import scatter_add_rows_
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


class MoE(nn.Module):
    """`init_moe` (:29-57): ``router`` (d, E), ``wi``/``wg`` (E, d, F) at
    0.02, ``wo`` (E, F, d) at 0.02/sqrt(2·n_layers); with shared experts
    ``shared_wi``/``shared_wg`` (d, Fs) and ``shared_wo`` (Fs, d),
    Fs = moe_d_ff · n_shared_experts."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        d, E, Fe = cfg.d_model, cfg.n_routed_experts, cfg.moe_d_ff
        s, so = 0.02, 0.02 / math.sqrt(2 * cfg.n_layers)
        self.router = layers.normal((d, E), s, generator, device)
        self.wi = layers.normal((E, d, Fe), s, generator, device)
        self.wg = layers.normal((E, d, Fe), s, generator, device)
        self.wo = layers.normal((E, Fe, d), so, generator, device)
        if cfg.n_shared_experts:
            Fs = cfg.moe_d_ff * cfg.n_shared_experts
            self.shared_wi = layers.normal((d, Fs), s, generator, device)
            self.shared_wg = layers.normal((d, Fs), s, generator, device)
            self.shared_wo = layers.normal((Fs, d), so, generator, device)


def top_k_lowest_ties(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` over the last dim: the k largest values in descending
    order, the lowest index first among equal values (a stable descending
    sort keeps the index order of ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params: MoE, x2d: torch.Tensor, cfg: ModelConfig):
    """Router: softmax-then-topk (DeepSeek-V2). Returns (weights (T,k),
    expert ids (T,k), aux load-balance loss)."""
    logits = torch.einsum("td,de->te", x2d.float(), params.router.float())
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k_lowest_ties(probs, cfg.moe_top_k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style aux loss: E * sum_e f_e * p_e
    E = cfg.n_routed_experts
    me = probs.mean(0)                                          # mean router prob
    flat = idx.reshape(-1)      # route counts: exact sums of ones, no host sync (bincount syncs)
    counts = torch.zeros((E,), dtype=torch.float32, device=x2d.device).scatter_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=x2d.device))
    ce = counts / (x2d.shape[0] * cfg.moe_top_k)
    aux = E * torch.sum(me * ce)
    return w, idx, aux


def dispatch(idx: torch.Tensor, w: torch.Tensor, n_experts: int, first_expert: int,
             capacity: int):
    """The capacity-bounded grouping of `_grouped_expert_ffn` (:93-107): for
    each of ``n_experts`` experts from ``first_expert``, its window of
    ``capacity`` sorted routes. Returns (tokens (E, C), weights (E, C),
    valid (E, C) bool): a route outside its expert's window is dropped, a
    slot of the window holding another expert's route is invalid."""
    T, k = idx.shape
    N = T * k
    dev = idx.device
    eid = idx.reshape(-1)
    tok = torch.arange(T, device=dev).repeat_interleave(k)
    ww = w.reshape(-1)
    order = torch.sort(eid, stable=True).indices
    eid_s, tok_s, w_s = eid[order], tok[order], ww[order]
    experts = first_expert + torch.arange(n_experts, device=dev, dtype=eid.dtype)
    starts = torch.searchsorted(eid_s, experts)
    starts = torch.clamp(starts, 0, N - capacity)               # dynamic_slice's clamp
    slots = starts[:, None] + torch.arange(capacity, device=dev)[None, :]
    valid = eid_s[slots] == experts[:, None]
    return tok_s[slots], w_s[slots], valid


def _grouped_expert_ffn(
    params_wi, params_wg, params_wo,   # (E_loc, d, F), (E_loc, F, d)
    x2d: torch.Tensor,                 # (T, d) tokens
    w: torch.Tensor,                   # (T, k) combine weights
    idx: torch.Tensor,                 # (T, k) global expert ids
    first_expert: int,                 # id of params_wi[0]
    capacity: int,
    dtype,
) -> torch.Tensor:
    """Capacity-bounded sorted dispatch for the E_loc experts given:
    gather → SwiGLU FFN → scatter-add, masked to each expert's own routes."""
    E_loc = params_wi.shape[0]
    ts, ws, valid = dispatch(idx, w, E_loc, first_expert, capacity)
    vmask = valid.to(dtype)
    xs = x2d[ts] * vmask[..., None]                             # (E, C, d)
    h = torch.einsum("ecd,edf->ecf", xs, params_wi.to(dtype))
    g = torch.einsum("ecd,edf->ecf", xs, params_wg.to(dtype))
    o = torch.einsum("ecf,efd->ecd", F.silu(g) * h, params_wo.to(dtype))
    y = torch.zeros_like(x2d)
    return scatter_add_rows_(y, (ts.reshape(-1),),
                             (o * (ws.to(dtype) * vmask)[..., None]).reshape(-1, x2d.shape[1]))


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * cfg.moe_top_k / cfg.n_routed_experts * cfg.capacity_factor))
    # clamp to the total route count (tiny decode batches); at least 1 slot
    return max(1, min(c, n_tokens * cfg.moe_top_k))


def _shared_ffn(params: MoE, x, dtype):
    h = torch.einsum("...d,df->...f", x, params.shared_wi.to(dtype))
    g = torch.einsum("...d,df->...f", x, params.shared_wg.to(dtype))
    return torch.einsum("...f,fd->...d", F.silu(g) * h, params.shared_wo.to(dtype))


def moe_ffn_local(params: MoE, x: torch.Tensor, cfg: ModelConfig, dtype):
    """Single-device path. x: (B, S, d). Returns (y, aux)."""
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    w, idx, aux = _route(params, x2d, cfg)
    cap = moe_capacity(cfg, x2d.shape[0])
    y = _grouped_expert_ffn(params.wi, params.wg, params.wo, x2d, w, idx, 0, cap, dtype)
    if cfg.n_shared_experts:
        y = y + _shared_ffn(params, x2d, dtype)
    return y.reshape(B, S, d), aux
