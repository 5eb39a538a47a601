"""Small tree utilities over nested dicts (and lists or tuples) of tensors
or arrays — port of `src/repro/utils/tree.py` (`tree_size`, `tree_bytes`,
`global_norm`, `tree_add`, `tree_scale`, `tree_zeros_like`, `tree_cast`,
`tree_paths`); `tree_map_with_path` is the port's counterpart of
`jax.tree_util.tree_map_with_path` with the paths '/'-joined. An `nn.Module` counts as the tree of its named parameters
(``a.b.c`` read as ``a/b/c``), so `tree_bytes(abstract_params(cfg))`
counts a model on the meta device without allocating it.
"""
from __future__ import annotations

import torch
from torch import nn


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *rs) for v, *rs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples, ``path``
    the leaf's '/'-joined keys and indices (as `tree_paths` gives them)."""
    join = lambda key: f"{prefix}/{key}" if prefix else str(key)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, join(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_size(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(int(x.numel()) if isinstance(x, torch.Tensor) else int(x.size)
               for x in _leaves(tree))


def tree_bytes(tree) -> int:
    return sum(int(x.numel()) * x.element_size() if isinstance(x, torch.Tensor)
               else int(x.size) * x.dtype.itemsize for x in _leaves(tree))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in _leaves(tree)))


def tree_add(a, b):
    if isinstance(a, dict):
        return {k: tree_add(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(tree_add(x, y) for x, y in zip(a, b))
    return a + b


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_paths(tree) -> list[tuple[str, object]]:
    """List of ('/'-joined key path, leaf) pairs, dict keys sorted as the
    reference's flatten sorts them; a module's parameters in their
    registration order."""
    if isinstance(tree, nn.Module):
        return [(name.replace(".", "/"), p) for name, p in tree.named_parameters()]
    out: list[tuple[str, object]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + [str(i)])
        else:
            out.append(("/".join(prefix), node))

    walk(tree, [])
    return out
