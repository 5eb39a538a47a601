"""Mixture-of-Experts FFN (DeepSeek-V2 / Jamba style: shared + routed
top-k) — port of `src/repro/models/moe.py` (all of it: `init_moe` with
its logical-axis specs, `_route`, `_grouped_expert_ffn`, `moe_capacity`,
`_shared_ffn`, `moe_ffn_local`, and the expert-parallel `moe_ffn_sharded`,
:147-240).

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

`moe_ffn_sharded` is one rank's share of the reference's `shard_map`
body: experts split on ``model`` (E/n_model a rank), tokens split on the
batch axes, no token exchange; the partial outputs are summed over
``model`` and the router's aux averaged over the batch axes (the
collectives of `sharding/spmd.py`, with their backward). Its windows are
`moe_ffn_local`'s (stable sort, clamped windows) on the rank's experts,
with the capacity of the rank's tokens, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import spmd

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


def moe_specs(cfg: ModelConfig) -> dict:
    """The logical axes `init_moe` returns (:40-56)."""
    specs = {"router": ("embed_nodiv", None), "wi": ("experts", "embed", "expert_ff"),
             "wg": ("experts", "embed", "expert_ff"), "wo": ("experts", "expert_ff", "embed")}
    if cfg.n_shared_experts:
        specs |= {"shared_wi": ("embed", "ff"), "shared_wg": ("embed", "ff"),
                  "shared_wo": ("ff", "embed")}
    return specs


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


def _local_experts(w, f_dim: int, mesh, x_axes: tuple, ws_axes: tuple) -> torch.Tensor:
    """This rank's block of a routed weight (E, d, F) or (E, F, d): its
    E/n_model experts and, with ``ws_axes``, its slice of F over them.
    ``w`` is a DTensor (gathered over what it shards beyond that block,
    differentiably onto its stored shard) or a plain full tensor."""
    names = spmd.axis_names(mesh)
    if not hasattr(w, "placements"):
        w = spmd.local_block(w, mesh, ("model",), dim=0)
        return spmd.local_block(w, mesh, ws_axes, dim=f_dim) if ws_axes else w
    dims = spmd.shard_dims(w)
    on_model = dims[names.index("model")] == 0
    in_place = bool(ws_axes) and all(dims[names.index(a)] == f_dim for a in ws_axes)
    modes = []
    for a, d in zip(names, dims):
        if a == "model":
            modes.append(spmd.KEEP if on_model else spmd.PARTIAL)
        elif in_place and a in ws_axes:
            modes.append(spmd.KEEP)
        else:
            modes.append(spmd.PARTIAL if a in x_axes or a in ws_axes else spmd.REPLICATE)
    out = spmd.gather(w, tuple(modes))
    if not on_model:
        out = spmd.local_block(out, mesh, ("model",), dim=0)
    if ws_axes and not in_place:
        out = spmd.local_block(out, mesh, ws_axes, dim=f_dim)
    return out


def moe_layout(cfg: ModelConfig, B: int, mesh, weight_stationary: bool = False
               ) -> tuple[tuple, tuple]:
    """(x_axes, ws_axes) of `moe_ffn_sharded` at global batch ``B``: the
    batch axes the tokens are split on (none when B does not divide), and
    the axes expert_ff is split on (the batch axes when weight-stationary
    and moe_d_ff divides, else none: plain expert parallelism)."""
    batch = tuple(a for a in spmd.axis_names(mesh) if a != "model")
    x_axes = batch if B % spmd.axis_size(mesh, batch) == 0 else ()
    ws_axes = batch if weight_stationary else ()
    if ws_axes and cfg.moe_d_ff % spmd.axis_size(mesh, ws_axes) != 0:
        ws_axes = ()     # divisibility fallback: plain EP
    return x_axes, ws_axes


def moe_ffn_sharded(params, x, cfg: ModelConfig, dtype, mesh, weight_stationary: bool = False):
    """Expert-parallel path on a `DeviceMesh`: experts split on ``model``,
    tokens split on the batch axes, no token exchange. Output summed over
    ``model``; aux averaged over the batch axes.

    ``x`` is a DTensor (B, S, d) on ``mesh``: Shard(0) over the batch axes
    when B divides their size, else replicated (as `launch/specs.py` lays
    a batch out); the output has its placements. ``params`` holds the
    router and the shared experts as plain tensors and the routed
    ``wi``/``wg``/``wo`` as DTensors (or plain full tensors).

    ``weight_stationary=True`` (decode-time): expert weights additionally
    split over the batch axes on their hidden (F) dim and left where they
    are stored; the tokens are all-gathered over the batch axes instead,
    the partial outputs summed over the whole mesh and this shard's batch
    slice kept."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    B, S, d = x.shape
    E = cfg.n_routed_experts
    names = spmd.axis_names(mesh)
    n_model = spmd.axis_size(mesh, ("model",))
    assert E % n_model == 0, (E, n_model)
    E_loc = E // n_model
    x_axes, ws_axes = moe_layout(cfg, B, mesh, weight_stationary)
    want = tuple(Shard(0) if a in x_axes else Replicate() for a in names)
    if tuple(x.placements) != want:
        raise ValueError(f"x is laid out {x.placements}; moe_ffn_sharded wants {want}")
    xl = x.to_local()
    Bl = xl.shape[0]
    split = ("model", *ws_axes)                 # what the experts' work is split over
    gathered = ws_axes and x_axes
    xg = spmd.gather_fwd(xl, mesh, x_axes) if gathered else xl
    xg = spmd.sum_bwd(xg, mesh, tuple(a for a in split if not (gathered and a in x_axes)))
    x2d = xg.reshape(-1, d)
    w, idx, aux = _route(params, x2d, cfg)
    # every rank of ``split`` routes the same tokens: its aux gradient is one share of n
    aux = spmd.grad_scale(aux, 1.0 / spmd.axis_size(mesh, split))
    cap = moe_capacity(cfg, x2d.shape[0])
    first = spmd.coordinate(mesh, ("model",)) * E_loc
    wi = _local_experts(params.wi, 2, mesh, x_axes, ws_axes)
    wg = _local_experts(params.wg, 2, mesh, x_axes, ws_axes)
    wo = _local_experts(params.wo, 1, mesh, x_axes, ws_axes)
    y = _grouped_expert_ffn(wi, wg, wo, x2d, w, idx, first, cap, dtype)
    if gathered:
        y = spmd.scatter_fwd(y.reshape(-1, S, d), mesh, x_axes)
        y = spmd.sum_fwd(y, mesh, tuple(a for a in split if a not in x_axes))
    else:
        y = spmd.sum_fwd(y, mesh, split)
    if x_axes:
        aux = spmd.mean_over(aux, mesh, x_axes)
    y = y.reshape(Bl, S, d)
    if cfg.n_shared_experts:
        # shared experts: outside the expert-parallel region, on this rank's tokens
        y = y + _shared_ffn(params, xl, dtype)
    return DTensor.from_local(y, mesh, want, run_check=False), aux
