"""Checkpointing: a nested dict of tensors and numpy arrays <-> a directory
of ``.npy`` leaves and a ``manifest.json`` — port of
`src/repro/checkpoint/ckpt.py:26-152` (`CorruptCheckpointError`, `save`,
`restore`, `verify`, `latest_step`, `steps`).

The layout is the reference's, so a snapshot written by either package
restores in the other: one ``<key>__<key>.npy`` file per leaf (dict keys
joined by ``__``, visited in sorted key order as `jax.tree_util` flattens
a dict), and a manifest holding ``step`` and, per leaf, ``file``,
``shape``, ``dtype``, ``raw`` and ``sha256``. A ``raw`` leaf (a dtype
numpy cannot store, such as bfloat16) is saved as its flat bytes and
reshaped from the manifest on restore.

Integrity: ``save`` records a sha256 per leaf file; ``restore`` checks each
leaf's bytes before reading them and raises `CorruptCheckpointError` on a
mismatch or a missing file. ``verify`` is the non-raising check that
`robustness.recovery.resolve_step_dir` uses to fall back from a corrupted
latest snapshot. Manifests written before checksums existed (no
``sha256`` key) restore unverified.

Tensors are read back to the host with ``.cpu()`` (the card is
synchronised first, so the bytes are those of the finished work);
`restore` puts the leaves that are tensors in ``like`` on the ``device``
it is given, and returns numpy arrays for the others.
"""
from __future__ import annotations

import hashlib
import json
import pathlib

import numpy as np
import torch

from repro_torch import device as device_lib


class CorruptCheckpointError(RuntimeError):
    """A checkpoint leaf failed its manifest sha256 (or is missing)."""


def _sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _flatten(tree, prefix: str = "") -> dict:
    """``{"a/b": leaf}`` for a nested dict, keys visited in sorted order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for key in sorted(tree, key=str):
        out.update(_flatten(tree[key], f"{prefix}/{key}" if prefix else str(key)))
    return out


def _unflatten_like(like, leaves: dict, prefix: str = ""):
    if not isinstance(like, dict):
        return leaves[prefix]
    return {key: _unflatten_like(sub, leaves, f"{prefix}/{key}" if prefix else str(key))
            for key, sub in like.items()}


def _host_leaf(leaf) -> tuple[np.ndarray, str, bool]:
    """(array to save, dtype name, raw) for one leaf. A bfloat16 tensor,
    which numpy cannot hold, saves as its flat bytes."""
    if torch.is_tensor(leaf):
        t = leaf.detach().contiguous()
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.reshape(-1).view(torch.uint8).numpy(), "bfloat16", True
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    raw = arr.dtype.kind not in "biufc"   # e.g. a numpy void dtype
    if raw:
        return np.ascontiguousarray(arr).reshape(-1).view(np.uint8), str(arr.dtype), True
    return arr, str(arr.dtype), False


def save(path: str | pathlib.Path, tree, step: int | None = None) -> None:
    """Write ``tree`` (a nested dict of tensors / numpy arrays) under
    ``path``: one ``.npy`` per leaf and the manifest."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in _flatten(tree).items():
        arr, dtype, raw = _host_leaf(leaf)
        shape = list(leaf.shape) if torch.is_tensor(leaf) else list(np.shape(leaf))
        fn = name.replace("/", "__") + ".npy"
        np.save(path / fn, arr)
        manifest["leaves"][name] = {
            "file": fn, "shape": shape, "dtype": dtype, "raw": raw,
            "sha256": _sha256(path / fn),
        }
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))


def _raw_dtype(name: str):
    """The dtype of a raw leaf: a torch dtype (``bfloat16``) or, failing
    that, a numpy one."""
    dt = getattr(torch, name, None)
    return dt if isinstance(dt, torch.dtype) else np.dtype(name)


def restore(path: str | pathlib.Path, like, device="cuda"):
    """Restore into the structure of ``like`` (a nested dict whose leaves
    are tensors or numpy arrays). Leaves that are tensors in ``like`` come
    back as tensors on ``device``; the others as numpy arrays."""
    path = pathlib.Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    flat_like = _flatten(like)
    dev = (device_lib.resolve(device)
           if any(torch.is_tensor(x) for x in flat_like.values()) else None)
    leaves = {}
    for name, want in flat_like.items():
        info = manifest["leaves"][name]
        f = path / info["file"]
        if not f.exists():
            raise CorruptCheckpointError(f"missing leaf file {f}")
        if "sha256" in info and _sha256(f) != info["sha256"]:
            raise CorruptCheckpointError(
                f"leaf {name!r} at {f} fails its manifest sha256 — the "
                "checkpoint is corrupted on disk")
        arr = np.load(f)
        if info.get("raw"):
            dt = _raw_dtype(info["dtype"])
            if isinstance(dt, torch.dtype):
                arr = torch.from_numpy(arr).view(dt).reshape(info["shape"])
            else:
                arr = arr.view(dt).reshape(info["shape"])
        if torch.is_tensor(want):
            arr = torch.as_tensor(arr).to(dev)
        elif torch.is_tensor(arr):
            raise ValueError(f"leaf {name!r} is {info['dtype']}, which numpy cannot hold; "
                             "restore it into a tensor")
        leaves[name] = arr
    return _unflatten_like(like, leaves)


def verify(path: str | pathlib.Path) -> bool:
    """Non-raising integrity check of one checkpoint directory: manifest
    readable and every leaf file present with a matching sha256 (leaves
    from pre-checksum manifests pass — nothing to verify against)."""
    path = pathlib.Path(path)
    try:
        manifest = json.loads((path / "manifest.json").read_text())
    except (OSError, ValueError):
        return False
    for info in manifest.get("leaves", {}).values():
        f = path / info["file"]
        if not f.exists():
            return False
        if "sha256" in info and _sha256(f) != info["sha256"]:
            return False
    return True


def steps(root: str | pathlib.Path) -> list[int]:
    """All step numbers under a checkpoint root, ascending."""
    root = pathlib.Path(root)
    return sorted(
        int(p.name.split("_")[-1])
        for p in root.glob("step_*")
        if p.is_dir() and (p / "manifest.json").exists())


def latest_step(root: str | pathlib.Path) -> int | None:
    found = steps(root)
    return found[-1] if found else None
