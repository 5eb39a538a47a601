"""DMF's decentralized protocol applied to a transformer's learners — port
of `src/repro/core/gossip.py` (`GossipConfig`, `default_personal`,
`_is_personal`, `ring_mix`, `mix_global`, `stack_params`,
`stacked_specs`, `consensus_error`; :30-119), with the ring mixing and
the consensus error of learners that are ranks (`ring_mix_ranks`,
`consensus_error_ranks`).

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

On one device the L learners are a leading dim of tensors and a round is
``torch.roll`` along it (`ring_mix`, `mix_global`). On a mesh
(`launch/train.py`'s gossip step with ``mesh=``) a learner is a coordinate
of the mesh axis ``learner_axis`` and holds its own replica, stored as
`stacked_specs` lays it out; a round is `ring_mix_ranks`: each learner's
global leaves go to its ring neighbours on that axis's sub-group and come
back from them (``dist.batch_isend_irecv``), the counterpart of the
collective-permute XLA lowers the reference's rolls to. Personal leaves are
never sent.

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


def stacked_specs(spec_tree, learner_axis: str):
    """Prepend the learner axis to every logical spec tuple, as a direct
    mesh-axis pin that `sharding.rules.resolve_spec` understands."""
    from repro_torch.sharding.rules import is_spec_leaf
    if is_spec_leaf(spec_tree):
        return (f"__mesh__{learner_axis}", *spec_tree)
    return {k: stacked_specs(v, learner_axis) for k, v in spec_tree.items()}


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


def ring_mix_ranks(x: torch.Tensor, cfg: GossipConfig, mesh) -> torch.Tensor:
    """`ring_mix` at one learner of a mesh: this learner's leaf ``x`` and
    its ring neighbours' on ``cfg.learner_axis`` (received from them), in
    the same order of sums as `ring_mix`."""
    from repro_torch.sharding import spmd
    w_self = cfg.self_weight
    w_nbr = (1.0 - w_self) / 2.0
    left, right = spmd.ring_neighbours(x, mesh, cfg.learner_axis)
    return (w_self * x + w_nbr * left + w_nbr * right).to(x.dtype)


@torch.no_grad()
def mix_global_ranks(params, cfg: GossipConfig, mesh) -> None:
    """`mix_global` for learners that are ranks: Ŵ^D on this learner's
    global leaves, in place; personal leaves untouched and never sent.
    ``params`` is the learner's tree of local tensors (a leaf's periods a
    list sharing its path)."""
    from repro_torch.optim.optimizers import named_leaves
    for path, x in named_leaves(params):
        if _is_personal(cfg, path):
            continue
        y = x
        for _ in range(cfg.walk_length):
            y = ring_mix_ranks(y, cfg, mesh)
        x.copy_(y)


@torch.no_grad()
def consensus_error_ranks(params, cfg: GossipConfig, mesh) -> torch.Tensor:
    """`consensus_error` for learners that are ranks: the learners' mean of
    each global leaf (its periods together, as the reference stacks them)
    by an all-reduce over the learner axis, then the deviations' and the
    mean's largest magnitudes by MAX over the mesh."""
    from repro_torch.optim.optimizers import named_leaves
    from repro_torch.sharding import spmd
    axes = spmd.axis_names(mesh)
    L = spmd.axis_size(mesh, (cfg.learner_axis,))
    num: dict = {}
    den: dict = {}
    for path, x in named_leaves(params):
        if _is_personal(cfg, path):
            continue
        mean = spmd.all_reduce(x, mesh, (cfg.learner_axis,)) / L
        a, b = torch.max(torch.abs(x - mean)), torch.max(torch.abs(mean))
        num[path] = torch.maximum(num[path], a) if path in num else a
        den[path] = torch.maximum(den[path], b) if path in den else b
    if not num:
        return torch.zeros(())
    nums = spmd.all_reduce(torch.stack(list(num.values())), mesh, axes, op="max")
    dens = spmd.all_reduce(torch.stack(list(den.values())), mesh, axes, op="max")
    return torch.max(nums / torch.clamp(dens, min=1e-8))
