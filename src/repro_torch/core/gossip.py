"""DMF's decentralized protocol applied to a transformer's learners — port
of `src/repro/core/gossip.py` (`GossipConfig`, `default_personal`,
`_is_personal`, `ring_mix`, `mix_global`, `stack_params`,
`consensus_error`; :30-119 but `stacked_specs`).

The paper's three mechanisms, for LM training:

1. **Learners** — every learner holds its own model replica: parameters
   gain a leading learner dim L (`stack_params`).
2. **Nearby-user communication + random walk** — after each local update,
   the *global* parameter partition is mixed with a doubly-stochastic ring
   weighting; ``walk_length`` (the paper's D) rounds of mixing apply Ŵ^D.
3. **Global/local decomposition (p vs q^i)** — parameters matching
   ``personal_predicate`` (default: norm scales and biases) are *never*
   mixed: each learner keeps its personal copy, exactly like q^i_j in
   Eq. 5. Everything else is the shared p.

Here the L learners are a leading dim of tensors on one device and a
round is ``torch.roll`` along it. The reference runs the same rolls on a
learner-sharded mesh axis, where XLA lowers them to collective-permutes;
learners as `torch.distributed` ranks exchanging with their ring
neighbours, and `stacked_specs` (logical sharding of the stacked tree),
belong to the mesh half of the port.

Trees are the reference's parameter trees (nested dicts of tensors), and
the personal predicate receives the reference's '/'-joined path string
(``"blocks/0/attn/bq"``), so a predicate written for the reference works
unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.utils import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    learner_axis: str = "data"       # the reference's mesh axis acting as the learner ring
    walk_length: int = 2             # D — rounds of neighbor mixing per step
    self_weight: float = 0.5         # ring mixing: self + left/right neighbors
    personal_predicate: Callable | None = None   # path -> bool (True = q^i)


def default_personal(path_str: str) -> bool:
    """The q^i partition: per-learner norms/biases (cheap, personal)."""
    leaf = path_str.split("/")[-1]
    return leaf.startswith(("ln", "norm", "final_norm", "b", "gate")) or "norm" in leaf


def _is_personal(cfg: GossipConfig, path: str) -> bool:
    pred = cfg.personal_predicate or default_personal
    return pred(path)


def ring_mix(x: torch.Tensor, cfg: GossipConfig) -> torch.Tensor:
    """One Ŵ-round: doubly-stochastic ring mixing along leading learner dim.

    x: (L, ...): w_self·x + w_nbr·roll(x, 1) + w_nbr·roll(x, -1), summed in
    that order."""
    w_self = cfg.self_weight
    w_nbr = (1.0 - w_self) / 2.0
    return (
        w_self * x
        + w_nbr * torch.roll(x, 1, dims=0)
        + w_nbr * torch.roll(x, -1, dims=0)
    ).to(x.dtype)


def mix_global(params, cfg: GossipConfig):
    """Apply Ŵ^D to the global (p) partition; personal (q^i) untouched."""

    def mix_leaf(path, x):
        if _is_personal(cfg, path):
            return x
        for _ in range(cfg.walk_length):
            x = ring_mix(x, cfg)
        return x

    return tree_lib.tree_map_with_path(mix_leaf, params)


def stack_params(params, n_learners: int):
    """Copy params to a leading learner dim (identical init, like DMF's
    shared p initialization); each learner's copy is its own storage."""
    return tree_lib.tree_map(
        lambda x: x.detach()[None].expand(n_learners, *x.shape).contiguous(), params)


def consensus_error(params, cfg: GossipConfig) -> torch.Tensor:
    """Max relative deviation of the global partition across learners —
    the convergence diagnostic for tests/monitoring."""
    errs = []
    device = None
    for path, x in tree_lib.tree_paths(params):
        device = x.device
        if _is_personal(cfg, path):
            continue
        mean = torch.mean(x, dim=0, keepdim=True)
        num = torch.max(torch.abs(x - mean))
        den = torch.clamp(torch.max(torch.abs(mean)), min=1e-8)
        errs.append(num / den)
    return torch.max(torch.stack(errs)) if errs else torch.zeros((), device=device)
