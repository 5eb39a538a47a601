"""Training launcher: the train steps for any --arch — port of
`src/repro/launch/train.py` (`TrainState`, `make_train_step`,
`_make_allreduce_step`, `_make_gossip_step`; :32-151) on one device.

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

The reference builds its steps on a mesh: FSDP/TP parameter shardings
(`rules.params_pspecs`, `_opt_shardings`), learners along a mesh axis
mixed by collective-permutes. Those wait for the port's mesh half, as do
learners as `torch.distributed` ranks exchanging with their ring
neighbours. The learner count L, which the reference reads from the mesh
axis, is ``n_learners`` here (the reference's examples and tests use a
(4, 2) mesh with learners along ``data``: 4).

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

from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch import device as device_lib
from repro_torch.core import gossip as gossip_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import optimizers as optim_lib
from repro_torch.optim.optimizers import AdamState, Optimizer, OptState
from repro_torch.utils import tree as tree_lib


class TrainState(NamedTuple):
    params: Any
    opt_state: Any


def make_train_step(cfg: ModelConfig, opt: Optimizer, *, sync: str = "allreduce",
                    gossip: gossip_lib.GossipConfig | None = None, n_learners: int = 4,
                    device="cuda"):
    """Returns (step_fn, init_fn). ``step_fn(state, batch) -> (state,
    metrics)``, the state updated in place and returned; ``batch`` holds
    ``tokens``, ``labels`` (and ``media``) as numpy arrays or tensors.
    ``init_fn(seed) -> TrainState`` draws the model with
    `transformer.init_params`. ``device``: cuda unless the caller asks for
    cpu; raises otherwise."""
    dev = device_lib.resolve(device)
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
    """`transformer.loss_fn` as a module's forward, for `functional_call`."""

    def __init__(self, model: transformer.Transformer):
        super().__init__()
        self.model = model

    def forward(self, batch: dict) -> torch.Tensor:
        return transformer.loss_fn(self.model, batch)


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

    def learner_loss(own: dict, batch: dict) -> torch.Tensor:
        """Learner loss through the template, its parameters views of
        ``own`` (the learner's reference tree)."""
        named = {}
        for name, (path, period) in places.items():
            leaf = _at(own, path)
            named["model." + name] = leaf if period is None else leaf[period]
        return torch.func.functional_call(template, named, (batch,))

    def step(state: TrainState, batch):
        lb = {k: v.reshape(L, v.shape[0] // L, *v.shape[1:]) for k, v in _on(batch, dev).items()}
        losses = []
        for i in range(L):
            params_i = tree_lib.tree_map(lambda x: x[i], state.params)
            own = tree_lib.tree_map(lambda x: x.detach().requires_grad_(), params_i)
            loss = learner_loss(own, {k: v[i] for k, v in lb.items()})
            flat = optim_lib.leaves(own)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = optim_lib.unflatten_like(
                own, [_grad_or_zeros(p, g) for p, g in zip(flat, grads)])
            del own, flat
            opt.update_(grads, _learner_state(state.opt_state, i), params_i)
            losses.append(loss.detach())
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
