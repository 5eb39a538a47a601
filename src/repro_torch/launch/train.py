"""Training launcher: the train steps for any --arch — port of
`src/repro/launch/train.py` (all of it: `TrainState`, `make_train_step`,
`_make_allreduce_step`, `_opt_shardings`, `_make_gossip_step`), on one
device and on a mesh.

Two synchronization modes (the paper's axis of comparison):
  * ``allreduce`` — the centralized baseline. On one device it is the
    reference's step (:75-80) without the implicit reduction over batch
    shards: the loss, its gradient by autograd over the port's modules,
    the optimiser applied in place (`Optimizer.update_`; the reference
    donates its state) and the step counter.
  * ``gossip`` — DMF-adapted (:130-148): L per-learner replicas stacked on
    a leading dim, the batch split learner-major ``(B, …) → (L, B/L, …)``,
    each learner's own gradient and optimiser step on its own slice
    (global-norm clipping per learner, as the reference's ``vmap`` of
    ``opt.update`` clips), then D rounds of ring mixing of the *global*
    partition (`core/gossip.py`). The reference ``vmap``s the learners; the
    port loops over them, each a `torch.func.functional_call` of one
    template model (on the meta device) on views of the learner's slice
    (MoE's data-dependent sort and gather do not ``vmap``).

On a mesh (``mesh=``, a `DeviceMesh` with the reference's axis names;
`_make_allreduce_mesh_step`, `_make_gossip_mesh_step`, :56-151) each rank
runs its share. The state is stored as DTensors with the placements
`sharding.rules.params_pspecs` resolves — FSDP on ``data``, tensor
dims on ``model`` — so a rank holds exactly the reference device's shard
of every parameter and AdamW moment (`_opt_shardings`). Each period's
parameters are gathered just before use (`sharding.spmd`), the
backward reduce-scatters each gradient onto its shard, the batch is split
over the batch axes as `launch/specs.py::batch_specs` says, and each
rank's CE is its tokens' sum over the whole batch's count of labels
>= 0 (`_share_of_loss`), so that the ranks' shares sum to the global
batch's mean, as the reference's loss over the sharded batch is; MoE layers go expert-parallel when
``model`` is wider than 1. The model-axis ranks of one batch shard
compute the dense layers redundantly: splitting heads, ff and vocab over
``model`` in compute is performance work for a later cell. AdamW's
clipping takes the norm of the logical gradient (each shard's squares
over its replica count, summed over the mesh). ``gossip``: one learner a
coordinate of ``learner_axis``, its replica stored as
`core.gossip.stacked_specs` lays it out (FSDP off when that axis is
``data``), mixed with its ring neighbours by sends and receives on the
axis's sub-group (`gossip.mix_global_ranks`).

    step, init_fn = make_train_step(cfg, adamw(3e-3), sync="allreduce")
    state = init_fn(0)
    state, metrics = step(state, data.batch(0))     # {"loss": 0-d tensor}

The states: ``allreduce`` keeps the model itself (`Transformer`) and the
optimiser state over `transformer.param_tree`; ``gossip`` keeps the
reference's parameter tree with every leaf stacked over learners
``(L, …)``, and the optimiser state likewise (the step an (L,) int32
tensor), as the reference's ``vmap``-ed init makes it.
`train_state_from_numpy` / `train_state_to_numpy` carry a state across
from and to the reference's numpy trees.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch import device as device_lib
from repro_torch.core import gossip as gossip_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import optimizers as optim_lib
from repro_torch.optim.optimizers import AdamState, Optimizer, OptState
from repro_torch.sharding import rules, spmd
from repro_torch.utils import tree as tree_lib


class TrainState(NamedTuple):
    params: Any
    opt_state: Any


def make_train_step(cfg: ModelConfig, opt: Optimizer, *, sync: str = "allreduce",
                    gossip: gossip_lib.GossipConfig | None = None, n_learners: int = 4,
                    device="cuda", mesh=None, rules_overrides: dict | None = None):
    """Returns (step_fn, init_fn). ``step_fn(state, batch) -> (state,
    metrics)``, the state updated in place and returned; ``batch`` holds
    ``tokens``, ``labels`` (and ``media``) as numpy arrays or tensors.
    ``init_fn(seed) -> TrainState`` draws the model with
    `transformer.init_params`. ``device``: cuda unless the caller asks for
    cpu; raises otherwise.

    With ``mesh`` (a `DeviceMesh`; every rank calls the step with the same
    global batch) the steps of the module docstring: ``init_fn(seed=0,
    model=None)`` shards a model that every rank holds alike (drawn from
    ``seed`` when not given); the learner count is the learner axis's
    size; ``rules_overrides`` remaps logical axes (`rules.DP_OVERRIDES`)."""
    dev = device_lib.resolve(device)
    if mesh is not None:
        if sync == "gossip":
            return _make_gossip_mesh_step(cfg, opt, gossip or gossip_lib.GossipConfig(), mesh, dev)
        if sync != "allreduce":
            raise ValueError(f"sync must be 'allreduce' or 'gossip', not {sync!r}")
        return _make_allreduce_mesh_step(cfg, opt, mesh, dev, rules_overrides)
    if sync == "gossip":
        return _make_gossip_step(cfg, opt, gossip or gossip_lib.GossipConfig(), n_learners, dev)
    if sync != "allreduce":
        raise ValueError(f"sync must be 'allreduce' or 'gossip', not {sync!r}")
    return _make_allreduce_step(cfg, opt, dev)


def _on(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _grad_or_zeros(p: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
    """A parameter the loss does not reach has a zero gradient, as in the
    reference."""
    return torch.zeros_like(p) if g is None else g


def _make_allreduce_step(cfg: ModelConfig, opt: Optimizer, dev: torch.device):
    def init_fn(seed: int = 0) -> TrainState:
        model = transformer.init_params(cfg, seed, device=dev)
        return TrainState(model, opt.init(transformer.param_tree(model)))

    def step(state: TrainState, batch):
        model = state.params
        if model.cfg != cfg or model.device != dev:
            raise ValueError(f"the model is {model.cfg.name}'s on {model.device}, "
                             f"the step {cfg.name}'s on {dev}")
        model.zero_grad(set_to_none=True)
        loss = transformer.loss_fn(model, _on(batch, dev))
        loss.backward()
        tree = transformer.param_tree(model)
        grads = tree_lib.tree_map(lambda p: _grad_or_zeros(p, p.grad), tree)
        opt_state = opt.update_(grads, state.opt_state, tree)
        del grads
        model.zero_grad(set_to_none=True)
        return TrainState(model, opt_state), {"loss": loss.detach()}

    return step, init_fn


def _stack_periods(node):
    """`transformer.param_tree` as the reference's tree: each list of
    periods stacked into one (n_periods, …) tensor."""
    if isinstance(node, dict):
        return {k: _stack_periods(v) for k, v in node.items()}
    if isinstance(node, list):
        return torch.stack([p.detach() for p in node])
    return node.detach()


def _at(tree: dict, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


class _LossOf(nn.Module):
    """`transformer.loss_fn` and its gradient with respect to ``wrt`` as a
    module's forward, for `functional_call`: the gradient is taken inside
    the call, while the parameters are swapped in, so that a remat
    period's recompute in the backward sees them too."""

    def __init__(self, model: transformer.Transformer):
        super().__init__()
        self.model = model

    def forward(self, batch: dict, wrt: list):
        loss = transformer.loss_fn(self.model, batch)
        return loss.detach(), torch.autograd.grad(loss, wrt, allow_unused=True)


def _learner_state(opt_state: OptState, i: int) -> OptState:
    """Learner i's optimiser state: views of the stacked state."""
    inner = opt_state.inner
    if isinstance(inner, AdamState):
        inner = AdamState(tree_lib.tree_map(lambda x: x[i], inner.mu),
                          tree_lib.tree_map(lambda x: x[i], inner.nu))
    elif inner != ():
        inner = tree_lib.tree_map(lambda x: x[i], inner)
    return OptState(opt_state.step[i], inner)


def _make_gossip_step(cfg: ModelConfig, opt: Optimizer, gcfg: gossip_lib.GossipConfig, L: int,
                      dev: torch.device):
    """Per-learner replicas + ring mixing (DMF protocol)."""
    template = _LossOf(transformer.abstract_params(cfg))
    places = transformer.reference_names(template.model)

    def init_fn(seed: int = 0) -> TrainState:
        stacked = gossip_lib.stack_params(
            _stack_periods(transformer.param_tree(transformer.init_params(cfg, seed, device=dev))),
            L)
        return TrainState(stacked, stacked_opt_init(opt, stacked))

    def learner_loss(own: dict, batch: dict) -> tuple:
        """Learner loss through the template, its parameters views of
        ``own`` (the learner's reference tree), and its gradient with
        respect to ``own``'s leaves."""
        named = {}
        for name, (path, period) in places.items():
            leaf = _at(own, path)
            named["model." + name] = leaf if period is None else leaf[period]
        return torch.func.functional_call(template, named, (batch, optim_lib.leaves(own)))

    def step(state: TrainState, batch):
        lb = {k: v.reshape(L, v.shape[0] // L, *v.shape[1:]) for k, v in _on(batch, dev).items()}
        losses = []
        for i in range(L):
            params_i = tree_lib.tree_map(lambda x: x[i], state.params)
            own = tree_lib.tree_map(lambda x: x.detach().requires_grad_(), params_i)
            loss, grads = learner_loss(own, {k: v[i] for k, v in lb.items()})
            flat = optim_lib.leaves(own)
            grads = optim_lib.unflatten_like(
                own, [_grad_or_zeros(p, g) for p, g in zip(flat, grads)])
            del own, flat
            opt.update_(grads, _learner_state(state.opt_state, i), params_i)
            losses.append(loss)
        # DMF step: mix the global partition with Ŵ^D
        params = gossip_lib.mix_global(state.params, gcfg)
        return TrainState(params, state.opt_state), {
            "loss": torch.mean(torch.stack(losses)),
            "consensus_err": gossip_lib.consensus_error(params, gcfg),
        }

    return step, init_fn


def stacked_opt_init(opt: Optimizer, stacked: dict) -> OptState:
    """The reference's ``jax.vmap(opt.init)`` of a learner-stacked tree:
    moments of the stacked shapes (every `init` is elementwise), one step
    count a learner."""
    state = opt.init(stacked)
    L = optim_lib.leaves(stacked)[0].shape[0]
    return OptState(torch.zeros((L,), dtype=torch.int32, device=state.step.device), state.inner)


# ---------------------------------------------------------------------------
# on a mesh
# ---------------------------------------------------------------------------
def _opt_shardings(opt: Optimizer, params_shape: dict, pspecs: dict):
    """Optimizer-state specs: moment leaves mirror their parameter's spec
    (matched by shape); scalars replicate. ``params_shape`` is the
    reference's tree of meta tensors (`transformer.param_shapes`)."""
    opt_shape = opt.init(params_shape)
    by_shape: dict = {}
    for (_, p), (_, s) in zip(tree_lib.tree_paths(params_shape), rules.spec_paths(pspecs)):
        by_shape.setdefault(tuple(p.shape), s)
    spec_of = lambda leaf: by_shape.get(tuple(leaf.shape), rules.P())
    inner = opt_shape.inner
    if isinstance(inner, AdamState):
        inner = AdamState(tree_lib.tree_map(spec_of, inner.mu), tree_lib.tree_map(spec_of, inner.nu))
    elif inner != ():
        inner = tree_lib.tree_map(spec_of, inner)
    return OptState(spec_of(opt_shape.step), inner)


def _local_rows(batch: dict, mesh, axes, dev) -> tuple[dict, bool]:
    """This rank's rows of a (B, …) batch over ``axes`` when B divides
    their size (`specs.batch_specs`), else the whole batch; and which."""
    b = _on(batch, dev)
    B = next(iter(b.values())).shape[0]
    if not axes or B % spmd.axis_size(mesh, axes):
        return b, False
    return {k: spmd.local_block(v, mesh, axes) for k, v in b.items()}, True


def _replicas(dt, mesh, axes) -> int:
    from torch.distributed.tensor import Replicate
    names = spmd.axis_names(mesh)
    return math.prod(mesh.size(names.index(a)) for a in axes
                     if isinstance(dt.placements[names.index(a)], Replicate))


def _logical_norm(grads: dict, mesh, axes, stacked: bool = False) -> torch.Tensor:
    """The norm of the logical tensors whose shards ``grads`` (a tree of
    DTensors) are, over the mesh ``axes``: each shard's sum of squares
    over the count of its replicas, summed over the ranks. ``stacked``:
    a leaf's periods summed as one stacked tensor, as the one-device
    gossip step's tree holds them (its order of sums, so that one learner
    a rank reproduces it bit for bit)."""
    terms = []
    for _, leaf in _path_groups(grads):
        if isinstance(leaf, list) and stacked:
            local = torch.stack([g.to_local() for g in leaf])
            terms.append(torch.sum(torch.square(local.float())) / _replicas(leaf[0], mesh, axes))
        else:
            terms += [torch.sum(torch.square(g.to_local().float())) / _replicas(g, mesh, axes)
                      for g in (leaf if isinstance(leaf, list) else [leaf])]
    return torch.sqrt(spmd.all_reduce(sum(terms), mesh, axes))


def _path_groups(tree, prefix: str = "") -> list:
    """(path, leaf or list of a leaf's periods), in `named_leaves` order."""
    if isinstance(tree, dict):
        return [pair for key in sorted(tree, key=str)
                for pair in _path_groups(tree[key], f"{prefix}/{key}" if prefix else str(key))]
    return [(prefix, tree)]


def _local(tree):
    return tree_lib.tree_map(lambda x: x.to_local(), tree)


def _local_state(state: OptState, step=None) -> OptState:
    inner = state.inner
    if isinstance(inner, AdamState):
        inner = AdamState(_local(inner.mu), _local(inner.nu))
    elif inner != ():
        inner = _local(inner)
    return OptState(state.step if step is None else step, inner)


def _grads(tree):
    return tree_lib.tree_map(lambda p: _grad_or_zeros(p, p.grad), tree)


def state_bytes(state: TrainState) -> int:
    """Bytes of this rank's shards of the state (parameters, gradients,
    moments, the step)."""
    params = transformer.param_tree(state.params) if isinstance(
        state.params, transformer.Transformer) else state.params
    grads = [p.grad for p in optim_lib.leaves(params) if p.grad is not None]
    return (spmd.local_shard_bytes(params) + spmd.local_shard_bytes(grads)
            + spmd.local_shard_bytes(state.opt_state))


def train_batch_axes(mesh, overrides: dict | None = None) -> tuple[str, ...]:
    """The axes an ``allreduce`` step splits its batch over: the whole mesh
    under the dp layout (``overrides`` with ``embed`` over ``model`` too,
    as `rules.DP_OVERRIDES` has it), else `launch.mesh.batch_axes`."""
    embed = (overrides or {}).get("embed")
    if isinstance(embed, tuple) and "model" in embed:
        return spmd.axis_names(mesh)
    return mesh_lib.batch_axes(mesh)


def _share_of_loss(model, batch: dict, rows: dict, ctx: spmd.MeshCompute, sharded: bool,
                   axes) -> torch.Tensor:
    """This rank's share of the loss of ``batch``, whose ``rows`` it holds:
    with the rows split over ``axes``, its CE summed over the whole
    batch's count of labels >= 0 and the router aux over the shard count,
    so that the shares sum, over ``axes``, to the batch's loss (the
    reference's `_loss` over the global batch) however the ignored labels
    fall; else the loss of the rows."""
    if not sharded:
        return transformer.loss_fn(model, rows, mesh=ctx)
    ce, aux = transformer.loss_terms(model, rows, mesh=ctx,
                                     n_labels=transformer.label_counts(batch["labels"]))
    return ce + model.cfg.router_aux_weight * aux / spmd.axis_size(ctx.mesh, axes)


def _make_allreduce_mesh_step(cfg: ModelConfig, opt: Optimizer, mesh, dev: torch.device,
                              overrides: dict | None):
    """FSDP + TP storage, the batch over the batch axes (:56-82)."""
    pspecs = rules.params_pspecs(transformer.param_specs(cfg), transformer.param_shapes(cfg),
                                 mesh, overrides=overrides)
    batch_axes = train_batch_axes(mesh, overrides)
    axes = spmd.axis_names(mesh)

    def init_fn(seed: int = 0, model: transformer.Transformer | None = None) -> TrainState:
        model = model if model is not None else transformer.init_params(cfg, seed, device=dev)
        transformer.distribute_params(model, mesh, pspecs, requires_grad=True)
        return TrainState(model, opt.init(transformer.param_tree(model)))

    def step(state: TrainState, batch):
        model = state.params
        b = _on(batch, dev)
        rows, sharded = _local_rows(b, mesh, batch_axes, dev)
        ctx = spmd.MeshCompute(mesh, dict(model.named_parameters()), cfg, batch_sharded=sharded,
                               batch_over=batch_axes)
        model.zero_grad(set_to_none=True)
        loss = _share_of_loss(model, b, rows, ctx, sharded, batch_axes)
        loss.backward()
        tree = transformer.param_tree(model)
        grads = _grads(tree)
        norm = _logical_norm(grads, mesh, axes)
        opt.update_(_local(grads), _local_state(state.opt_state), _local(tree), grad_norm=norm)
        del grads
        model.zero_grad(set_to_none=True)
        loss = spmd.all_reduce(loss.detach(), mesh, batch_axes) if sharded else loss.detach()
        return state, {"loss": loss}

    step.pspecs = pspecs
    return step, init_fn


def _make_gossip_mesh_step(cfg: ModelConfig, opt: Optimizer, gcfg: gossip_lib.GossipConfig,
                           mesh, dev: torch.device):
    """Per-learner replicas along ``gcfg.learner_axis`` + ring mixing by
    neighbour exchanges (:99-151). The state: the reference's tree, each
    leaf's periods a list, each tensor (L, …) a DTensor with Shard(0) over
    the learner axis (this rank holds its learner's replica, sharded over
    the other axes as `stacked_specs` resolves). The reference resolves
    the ``__mesh__data`` pin away under its fsdp=False rule (`rules`
    keeps that, leaf for leaf), which would hold all L replicas on every
    device; the port keeps the learner dim on its axis."""
    axis = gcfg.learner_axis
    L = spmd.axis_size(mesh, (axis,))
    me = mesh.get_local_rank(axis)
    template = transformer.abstract_params(cfg)
    places = transformer.reference_names(template)
    pspecs = rules.params_pspecs(gossip_lib.stacked_specs(transformer.param_specs(cfg), axis),
                                 transformer.param_shapes(cfg, lead=(L,)), mesh,
                                 fsdp=axis != "data")
    # the learner dim on its axis: the reference's fsdp=False rule also
    # drops the ``__mesh__data`` pin, which would hold every learner's
    # replica on every rank
    pspecs = rules.tree_from_paths((path, rules.P(axis, *spec[1:]))
                                   for path, spec in rules.spec_paths(pspecs))
    inner = tuple(a for a in mesh_lib.batch_axes(mesh) if a != axis)
    others = tuple(a for a in spmd.axis_names(mesh) if a != axis)

    def init_fn(seed: int = 0, model: transformer.Transformer | None = None) -> TrainState:
        model = model if model is not None else transformer.init_params(cfg, seed, device=dev)
        tree: dict = {}
        for name, p in model.named_parameters():
            path, period = places[name]
            spec = transformer.leaf_spec(pspecs, path, period, lead=1)
            dt = spmd.distribute(p.detach()[None].expand(L, *p.shape), mesh,
                                 rules.placements(spec, mesh), requires_grad=True)
            *parents, leaf = path.split("/")
            node = tree
            for key in parents:
                node = node.setdefault(key, {})
            if period is None:
                node[leaf] = dt
            else:
                node.setdefault(leaf, [None] * cfg.n_periods)[period] = dt
        del model
        state = opt.init(tree)
        return TrainState(tree, OptState(torch.zeros((L,), dtype=torch.int32, device=dev),
                                         state.inner))

    def step(state: TrainState, batch):
        b = _on(batch, dev)
        own = {k: v.reshape(L, v.shape[0] // L, *v.shape[1:])[me] for k, v in b.items()}
        rows, sharded = _local_rows(own, mesh, inner, dev)
        named = {name: (_at(state.params, path) if period is None
                        else _at(state.params, path)[period])
                 for name, (path, period) in places.items()}
        ctx = spmd.MeshCompute(mesh, named, cfg, batch_sharded=sharded, learner_axis=axis)
        for p in named.values():
            p.grad = None
        loss = _share_of_loss(template, own, rows, ctx, sharded, inner)
        loss.backward()
        grads = _grads(state.params)
        norm = _logical_norm(grads, mesh, others, stacked=True)
        step_me = state.opt_state.step[me].clone()
        opt.update_(_local(grads), _local_state(state.opt_state, step_me), _local(state.params),
                    grad_norm=norm)
        state.opt_state.step.add_(1)
        del grads
        for p in named.values():
            p.grad = None
        params = _local(state.params)
        gossip_lib.mix_global_ranks(params, gcfg, mesh)
        loss = spmd.all_reduce(loss.detach(), mesh, (axis, *inner) if sharded else (axis,)) / L
        return state, {"loss": loss,
                       "consensus_err": gossip_lib.consensus_error_ranks(params, gcfg, mesh)}

    step.pspecs = pspecs
    return step, init_fn


# ---------------------------------------------------------------------------
# the state carried across
# ---------------------------------------------------------------------------
def train_state_from_numpy(cfg: ModelConfig, opt: Optimizer, params: dict, opt_state=None, *,
                           sync: str = "allreduce", device="cuda") -> TrainState:
    """A train state from the reference's, as numpy (``jax.device_get``):
    ``params`` its parameter tree (for ``gossip`` stacked over learners),
    ``opt_state`` its optimiser state or None for a fresh `init`."""
    dev = device_lib.resolve(device)
    if sync == "gossip":
        stacked = tree_lib.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), params)
        state = (stacked_opt_init(opt, stacked) if opt_state is None
                 else optim_lib.state_from_numpy(opt_state, stacked))
        return TrainState(stacked, state)
    model = transformer.params_from_numpy(params, cfg, device=dev)
    tree = transformer.param_tree(model)
    state = opt.init(tree) if opt_state is None else optim_lib.state_from_numpy(opt_state, tree)
    return TrainState(model, state)


def train_state_to_numpy(state: TrainState) -> tuple[dict, OptState]:
    """(parameters, optimiser state) as the reference's numpy trees."""
    params = (transformer.params_to_numpy(state.params)
              if isinstance(state.params, transformer.Transformer)
              else optim_lib.tree_to_numpy(state.params))
    return params, optim_lib.state_to_numpy(state.opt_state)
