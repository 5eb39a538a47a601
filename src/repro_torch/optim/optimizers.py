"""Optimizers from scratch — port of `src/repro/optim/optimizers.py:22-148`
(`OptState`, `Optimizer`, `apply_updates`, `sgd`, `momentum` with
Nesterov, `AdamState`, `adamw`).

The reference's functional, pytree-based API, on trees of tensors (nested
dicts; see "Trees" below):

    opt = adamw(lr=1e-3, weight_decay=0.1)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

and, for the same optimiser, its arithmetic applied in place:

    state = opt.update_(grads, state, params)   # == update + apply_updates

The reference's train steps donate their state (`launch/train.py:81,
:150`), so XLA writes the new parameters and moments over the old ones.
`update_` is the port's counterpart: leaf after leaf, it writes the new
moments into the state's tensors, adds the update to the parameter in
place and advances the state's step in place, with the same operations in
the same order as `update` followed by `apply_updates` (equal bit for
bit). At qwen1.5-4b's width the functional form would allocate new
moments (31.6 GB) and an updates tree (15.8 GB) on top of 63.2 GB of
parameters, gradients and moments; `update_` holds a few leaf-sized
temporaries at a time.

Scalars keep the reference's types: a constant learning rate stays a
Python float (weak-typed in JAX, so rounded to float32 where it meets a
tensor), a schedule's rate is a float32 0-d tensor; the step is an int32
0-d tensor on the parameters' device. Moments are float32 whatever the
parameter's dtype.

**Trees.** Nested dicts (visited in sorted key order, as `jax.tree_util`
flattens a dict) whose leaves are tensors, or lists of tensors. A list
holds the per-period tensors of one leaf that the reference stacks over
periods (`transformer.param_tree`): its elements share the leaf's path
and are visited in period order. The weight-decay ``mask`` receives that
'/'-joined path string (``"blocks/0/attn/bq"``), where the reference's
receives the JAX key path of the same leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


class OptState(NamedTuple):
    step: torch.Tensor
    inner: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable     # (params) -> state
    update: Callable   # (grads, state, params) -> (updates, new_state)
    update_: Callable  # (grads, state, params) -> state; params and state written in place


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
def named_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in the reference's flatten order; a list's
    elements share the list's path."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree, key=str):
            out += named_leaves(tree[key], f"{prefix}/{key}" if prefix else str(key))
        return out
    if isinstance(tree, (list, tuple)):
        return [pair for leaf in tree for pair in named_leaves(leaf, prefix)]
    return [(prefix, tree)]


def leaves(tree) -> list[torch.Tensor]:
    return [leaf for _, leaf in named_leaves(tree)]


def unflatten_like(like, flat) -> Any:
    """A tree of ``like``'s structure holding the leaves of ``flat`` (an
    iterable in `named_leaves` order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node, key=str)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(like)


def apply_updates(params, updates):
    with torch.no_grad():
        return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
def sgd(lr) -> Optimizer:
    def init(params):
        return OptState(_step0(params), ())

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        upd = tree_map(lambda g: -lr_t * g, grads)
        return upd, OptState(step, ())

    @torch.no_grad()
    def update_(grads, state, params):
        state.step.add_(1)
        lr_t = _lr_at(lr, state.step)
        for p, g in zip(leaves(params), leaves(grads)):
            p.add_(-lr_t * g)
        return state

    return Optimizer(init, update, update_)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return OptState(_step0(params),
                        tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    def _upd(m, g, lr_t):
        return -lr_t * (beta * m + g) if nesterov else -lr_t * m

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        m = tree_map(lambda mo, g: beta * mo + g.float(), state.inner, grads)
        upd = tree_map(lambda mo, g: _upd(mo, g, lr_t), m, grads)
        return upd, OptState(step, m)

    @torch.no_grad()
    def update_(grads, state, params):
        state.step.add_(1)
        lr_t = _lr_at(lr, state.step)
        for p, mo, g in zip(leaves(params), leaves(state.inner), leaves(grads)):
            mo.mul_(beta).add_(g.float())
            p.add_(_upd(mo, g, lr_t))
        return state

    return Optimizer(init, update, update_)


class AdamState(NamedTuple):
    mu: Any
    nu: Any


def adamw(
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip_norm: float | None = 1.0,
    mask: Callable | None = None,   # path string -> bool: apply weight decay?
) -> Optimizer:
    """AdamW with global-norm clipping and decoupled weight decay.

    Optimizer moments are f32 regardless of param dtype (mixed-precision
    convention: bf16 params / f32 master-state handled by the caller).
    ``mask`` receives each leaf's '/'-joined path (module docstring)."""

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return OptState(_step0(params), AdamState(mu=tree_map(zeros, params),
                                                  nu=tree_map(zeros, params)))

    def _clip_scale(grads):
        """min(1, clip / (‖g‖ + 1e-9)) over the whole tree, or None."""
        if grad_clip_norm is None:
            return None
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(grads)))
        return torch.clamp(grad_clip_norm / (gnorm + 1e-9), max=1.0)

    def _schedule(step):
        lr_t = _lr_at(lr, step)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        return lr_t, bc1, bc2

    def _decays(params):
        return [weight_decay if mask is None or mask(path) else 0.0
                for path, _ in named_leaves(params)]

    def _upd(m, v, p, wd, lr_t, bc1, bc2):
        u = -lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if wd:
            u = u - lr_t * wd * p.float()
        return u

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        lr_t, bc1, bc2 = _schedule(step)
        grads = tree_map(lambda g: g.float(), grads)
        scale = _clip_scale(grads)
        if scale is not None:
            grads = tree_map(lambda g: g * scale, grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.inner.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g), state.inner.nu, grads)
        upds = [_upd(m, v, p, wd, lr_t, bc1, bc2) for m, v, p, wd in
                zip(leaves(mu), leaves(nu), leaves(params), _decays(params))]
        return unflatten_like(params, upds), OptState(step, AdamState(mu, nu))

    @torch.no_grad()
    def update_(grads, state, params):
        state.step.add_(1)
        lr_t, bc1, bc2 = _schedule(state.step)
        scale = _clip_scale(grads)
        for p, g, m, v, wd in zip(leaves(params), leaves(grads), leaves(state.inner.mu),
                                  leaves(state.inner.nu), _decays(params)):
            g = g.float()
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            del g
            p.add_(_upd(m, v, p, wd, lr_t, bc1, bc2))
        return state

    return Optimizer(init, update, update_)


# ---------------------------------------------------------------------------
# the optimiser state carried across
# ---------------------------------------------------------------------------
def tree_to_numpy(tree):
    """A tree of tensors as numpy arrays, each list of per-period tensors
    stacked over periods (the reference's layout)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):   # one stacked leaf's periods
        return np.stack([t.detach().cpu().numpy() for t in tree])
    return tree.detach().cpu().numpy()


def _tree_from_numpy(arrays, like):
    if isinstance(like, dict):
        return {k: _tree_from_numpy(arrays[k], v) for k, v in like.items()}
    arr = np.asarray(arrays)
    if isinstance(like, (list, tuple)):
        if arr.shape[0] != len(like):
            raise ValueError(f"a stacked leaf of {arr.shape[0]} periods for {len(like)}")
        return [_tree_from_numpy(arr[i], x) for i, x in enumerate(like)]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape {tuple(arr.shape)}, want {tuple(like.shape)}")
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(like.device)


def state_to_numpy(state: OptState) -> OptState:
    """The state as the reference holds it after ``jax.device_get``: the
    step as an int32 numpy scalar, the moments as trees of numpy arrays,
    each list of per-period tensors stacked over periods."""
    inner = state.inner
    if isinstance(inner, AdamState):
        inner = AdamState(tree_to_numpy(inner.mu), tree_to_numpy(inner.nu))
    elif inner != ():
        inner = tree_to_numpy(inner)
    return OptState(np.asarray(state.step.cpu().numpy(), np.int32), inner)


def state_from_numpy(state, params) -> OptState:
    """An optimiser state for ``params`` (a tree, as `init` takes it) from
    the reference's state as numpy (``jax.device_get(opt_state)``: any
    object with ``step`` and ``inner``, the inner ``()``, a tree, or one
    with ``mu`` and ``nu``). Each moment leaf goes to its parameter's
    device; a stacked leaf is split over the parameter's list of periods.
    Raises ValueError on a shape that does not match."""
    inner = state.inner
    if hasattr(inner, "mu") and hasattr(inner, "nu"):
        inner = AdamState(_tree_from_numpy(inner.mu, params), _tree_from_numpy(inner.nu, params))
    elif len(inner) == 0:
        inner = ()
    else:
        inner = _tree_from_numpy(inner, params)
    step = torch.as_tensor(np.array(state.step, np.int32), device=leaves(params)[0].device)
    return OptState(step, inner)
