"""Crash-consistent training checkpoints for `dmf.fit` — port of
`src/repro/robustness/recovery.py:40-141` (`save_training`,
`resolve_step_dir`, `load_training`).

Bit-identical resume needs the FULL loop state: the `DMFState` factors,
the numpy `Generator` stream (``bit_generator.state`` is a plain JSON
dict, so every later epoch re-samples the same minibatches, negatives and
DP seeds), the `DelayRing` of in-flight stale messages, and the
`GaussianAccountant` ledger. Given those, every epoch is a function of
(state, sampled stream), the DP noise is keyed by (epoch seed, row id),
and the port's scatters sum in a fixed order — so replaying from a
snapshot reproduces the uninterrupted run bit for bit.

Layout: ``<root>/step_<t>/`` with the arrays in the `checkpoint.ckpt`
format plus a ``training_state.json`` sidecar for the scalars (step, rng
state, loss history, accountant counters) — the reference's, so a
snapshot of either package resumes in the other.
"""
from __future__ import annotations

import json
import pathlib
import warnings

import numpy as np

from repro_torch import device as device_lib
from repro_torch.checkpoint import ckpt

SIDECAR = "training_state.json"


def _array_tree(state, ring, accountant) -> dict:
    tree = {"state": {"U": state.U, "P": state.P, "Q": state.Q}}
    if ring is not None:
        tree["ring"] = {"gp": ring.gp, "ui": ring.ui, "vj": ring.vj, "due": ring.due}
    if accountant is not None:
        tree["accountant"] = {"rdp": accountant._rdp, "messages": accountant.messages}
    return tree


def save_training(root, step: int, state, rng: np.random.Generator, ring=None,
                  accountant=None, train_losses=(), test_losses=()) -> pathlib.Path:
    """Snapshot the full training loop after ``step`` completed epochs;
    returns the ``step_<t>`` directory. The card is synchronised before
    the factors are read back."""
    path = pathlib.Path(root) / f"step_{step}"
    ckpt.save(path, _array_tree(state, ring, accountant), step=step)
    meta = {
        "step": int(step),
        "rng_state": rng.bit_generator.state,
        "train_losses": [float(x) for x in train_losses],
        "test_losses": [float(x) for x in test_losses],
        "has_ring": ring is not None,
        "accountant": None if accountant is None else {
            "epochs": int(accountant.epochs),
            "eps_trajectory": [float(e) for e in accountant.eps_trajectory],
        },
    }
    (path / SIDECAR).write_text(json.dumps(meta, indent=1))
    return path


def resolve_step_dir(path) -> pathlib.Path:
    """Accept either a ``step_<t>`` directory or a checkpoint root.

    Given a root, picks the latest step whose leaves VERIFY against their
    manifest sha256s: a torn or bit-rotted latest snapshot is skipped with
    a warning and resume falls back to the newest intact one. An
    explicitly named step dir is returned as is (restore then raises
    `CorruptCheckpointError` if it is bad)."""
    path = pathlib.Path(path)
    if (path / SIDECAR).exists():
        return path
    steps = ckpt.steps(path)
    if not steps:
        raise FileNotFoundError(f"no training checkpoints under {path}")
    for step in reversed(steps):
        cand = path / f"step_{step}"
        if ckpt.verify(cand) and (cand / SIDECAR).exists():
            if step != steps[-1]:
                warnings.warn(
                    f"checkpoint step_{steps[-1]} under {path} is corrupted"
                    f" or incomplete — falling back to step_{step}",
                    RuntimeWarning, stacklevel=2)
            return cand
    raise ckpt.CorruptCheckpointError(
        f"every checkpoint under {path} fails integrity verification")


def load_training(path, like_state, ring=None, accountant=None, device="cuda"):
    """Restore a `save_training` snapshot onto ``device``.

    ``like_state``/``ring``/``accountant`` give the restore shapes (and,
    for ring/accountant, the objects mutated in place — pass the same
    freshly constructed objects `fit` would otherwise start from).
    Returns ``(state, rng, ring, step, train_losses, test_losses)``."""
    from repro_torch.core import dmf as dmf_lib

    dev = device_lib.resolve(device)
    path = resolve_step_dir(path)
    meta = json.loads((path / SIDECAR).read_text())
    if meta["has_ring"] != (ring is not None):
        raise ValueError(
            f"checkpoint at {path} was written with has_ring="
            f"{meta['has_ring']} but resume constructed ring={ring}")
    out = ckpt.restore(path, _array_tree(like_state, ring, accountant), device=dev)
    state = dmf_lib.DMFState(U=out["state"]["U"], P=out["state"]["P"], Q=out["state"]["Q"])
    if ring is not None:
        ring.gp = out["ring"]["gp"]
        ring.ui = np.asarray(out["ring"]["ui"])
        ring.vj = np.asarray(out["ring"]["vj"])
        ring.due = np.asarray(out["ring"]["due"])
    if accountant is not None:
        acc = meta["accountant"]
        if acc is None:
            raise ValueError(f"checkpoint at {path} has no accountant ledger")
        accountant._rdp[:] = np.asarray(out["accountant"]["rdp"])
        accountant.messages[:] = np.asarray(out["accountant"]["messages"])
        accountant.epochs = int(acc["epochs"])
        accountant.eps_trajectory = [float(e) for e in acc["eps_trajectory"]]
    rng = np.random.default_rng()
    rng.bit_generator.state = meta["rng_state"]
    return (state, rng, ring, int(meta["step"]),
            list(meta["train_losses"]), list(meta["test_losses"]))
