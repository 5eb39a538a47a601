"""Logical-axis → mesh-axis resolution — port of
`src/repro/sharding/rules.py` (all of it: `LOGICAL_RULES`, `DP_OVERRIDES`,
`SERVE_WS_OVERRIDES`, `resolve_spec`, `params_pspecs`,
`params_shardings`).

`transformer.param_specs(cfg)` gives, for the reference's parameter tree,
tuples of logical axis names (one per tensor dim, or None). This module
resolves them into `PartitionSpec`s for a mesh, with the reference's
divisibility fallback: a dim whose size does not divide the product of its
mesh axes is replicated (qwen1.5-4b's 20 heads or minicpm3's 73,448 vocab
on a 16-wide model axis).

A mesh here is anything with ``axis_names`` and a name → size ``shape``
(`launch.mesh.MeshShape`, which needs no process group) or a live
`torch.distributed.device_mesh.DeviceMesh`. `PartitionSpec` is the port's
own small counterpart of jax's (a tuple of axis names, tuples of names or
None, with the same ``repr``). `placements` turns a spec into DTensor
placements on a `DeviceMesh`: an entry naming axis ``a`` on tensor dim
``d`` becomes ``Shard(d)`` on mesh dim ``a``, a tuple of axes on one dim
shards over each in mesh-dim order, every other mesh dim is
``Replicate()``; `params_placements` is the reference's
`params_shardings` in those terms.
"""
from __future__ import annotations

from typing import NamedTuple

# logical name -> mesh axis (train rules; "embed" is the FSDP dim)
LOGICAL_RULES: dict[str, str | None] = {
    "embed": "data",          # FSDP: weights gathered per layer
    "embed_nodiv": None,      # embed-sized dims kept replicated (norms, router)
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",
    "expert_ff": None,        # serve weight-stationary mode pins this to data
    "vocab": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
}

# pure data-parallel over the whole mesh for small dense models — removes
# tensor-parallel activation all-reduces; batch spans (data, model)
DP_OVERRIDES = {
    "embed": ("data", "model"),
    "ff": None, "heads": None, "kv_heads": None, "vocab": None,
    "ssm_inner": None, "ssm_heads": None, "experts": None,
}
# weight-stationary serving — weights resident (no FSDP gather); MoE
# expert hidden dim sharded over data (moe_ffn_sharded's ws path)
SERVE_WS_OVERRIDES = {"embed": None, "expert_ff": "data"}


class PartitionSpec(tuple):
    """One entry a tensor dim: an axis name, a tuple of names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> tuple[tuple[str, ...], dict[str, int]]:
    """(axis names, name → size) of a `MeshShape` or a `DeviceMesh`."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    sizes = mesh.shape if isinstance(mesh.shape, dict) else dict(zip(names, mesh.shape))
    return tuple(names), sizes


def is_spec_leaf(s) -> bool:
    """Spec trees are nested dicts; every tuple in one is a leaf."""
    return isinstance(s, tuple)


def resolve_spec(logical: tuple, shape: tuple[int, ...], mesh, *, fsdp: bool = True,
                 overrides: dict | None = None) -> PartitionSpec:
    """Map logical axes to a PartitionSpec, dropping non-divisible dims."""
    names, sizes = mesh_axes(mesh)
    out = []
    for name, size in zip(logical, shape):
        if name and name.startswith("__mesh__"):   # direct mesh-axis pin
            ax = name[len("__mesh__"):]
        elif overrides and name in overrides:
            ax = overrides[name]
        else:
            ax = LOGICAL_RULES.get(name) if name else None
        if ax == "data" and not fsdp and not (overrides and name in overrides):
            ax = None
        axs = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
        if not axs or any(a not in names for a in axs):
            out.append(None)
            continue
        n = 1
        for a in axs:
            n *= sizes[a]
        if size % n != 0:
            out.append(None)     # divisibility fallback -> replicate
            continue
        out.append(ax)
    return P(*out)


def spec_paths(spec_tree, prefix: str = "") -> list[tuple[str, tuple]]:
    """('/'-joined path, spec tuple) pairs of a spec tree, keys sorted."""
    if is_spec_leaf(spec_tree):
        return [(prefix, spec_tree)]
    out = []
    for key in sorted(spec_tree):
        out += spec_paths(spec_tree[key], f"{prefix}/{key}" if prefix else str(key))
    return out


def tree_from_paths(pairs) -> dict:
    """A nested dict from ('/'-joined path, leaf) pairs."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def params_pspecs(spec_tree, params_tree, mesh, *, fsdp: bool = True,
                  overrides: dict | None = None) -> dict:
    """Tree of PartitionSpec aligned with ``params_tree`` (the reference's
    tree: nested dicts whose leaves carry ``.shape``, e.g. the meta tensors
    of `transformer.param_shapes`)."""
    from repro_torch.utils import tree as tree_lib
    specs = spec_paths(spec_tree)
    shapes = tree_lib.tree_paths(params_tree)
    assert [p for p, _ in specs] == [p for p, _ in shapes], (len(specs), len(shapes))
    return tree_from_paths(
        (path, resolve_spec(s, tuple(leaf.shape), mesh, fsdp=fsdp, overrides=overrides))
        for (path, s), (_, leaf) in zip(specs, shapes))


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a `DeviceMesh`)."""
    from torch.distributed.tensor import Replicate, Shard
    names, _ = mesh_axes(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            out[names.index(a)] = Shard(d)
    return tuple(out)


class Placed(NamedTuple):
    """A leaf's sharding on a live mesh: the counterpart of `NamedSharding`."""
    mesh: object
    placements: tuple


def params_placements(spec_tree, params_tree, mesh, *, fsdp: bool = True,
                      overrides: dict | None = None) -> dict:
    """`params_shardings` (:89-95): `Placed(mesh, placements)` a leaf."""
    pspecs = params_pspecs(spec_tree, params_tree, mesh, fsdp=fsdp, overrides=overrides)
    return tree_from_paths((path, Placed(mesh, placements(s, mesh)))
                            for path, s in spec_paths(pspecs))


def local_bytes(pspecs: dict, params_tree, mesh) -> int:
    """Bytes of one rank's shards of ``params_tree`` laid out by ``pspecs``:
    each leaf's bytes over the product of the mesh axes its spec names."""
    from repro_torch.utils import tree as tree_lib
    _, sizes = mesh_axes(mesh)
    total = 0
    for (_, spec), (_, leaf) in zip(spec_paths(pspecs), tree_lib.tree_paths(params_tree)):
        n = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                n *= sizes[a]
        total += leaf.numel() * leaf.element_size() // n
    return total
