"""Faults planted in the program under a run, to show that the check
catches each fault a cell can have (`control.py` on the chip, the tests
here). Each patches one name of the program for the ``with`` block only.

- ``answer_altered`` (refresh): kernel 2's first slate of each dispatch
  gets its top POI id moved to the next id;
- ``half_batch`` (refresh): kernel 2 scores the first half of a
  dispatch's users, and the second half get those slates;
- ``state_unchanged`` (train): every scatter into U, P and Q is dropped,
  so a step returns the state it was given;
- ``half_batch`` (train): each round trains the first half of its events
  and reports twice their loss, the mean over the rest;
- ``loss_altered`` (train): kernel 3's round loss comes out 1% high.
"""
from __future__ import annotations

import contextlib

FAULTS = {"refresh": ("answer_altered", "half_batch"),
          "train": ("state_unchanged", "half_batch", "loss_altered")}


@contextlib.contextmanager
def _patched(module, name: str, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def planted(kind: str, fault: str):
    """A context manager that plants ``fault`` for traffic kind ``kind``."""
    from repro_torch.core import dmf
    from repro_torch.kernels import ops

    if fault not in FAULTS[kind]:
        raise ValueError(f"no fault {fault!r} for {kind} (have {FAULTS[kind]})")
    if kind == "refresh":
        def make(orig):
            def topk(U, V, mask, k, **kw):
                if fault == "half_batch":
                    h = max(U.shape[0] // 2, 1)
                    rows = kw.get("rows")
                    vals, idx = orig(U[:h], V, mask, k, **dict(kw, rows=None if rows is None
                                                                 else rows[:h]))
                    rep = (U.shape[0] + h - 1) // h
                    return vals.repeat(rep, 1)[:U.shape[0]], idx.repeat(rep, 1)[:U.shape[0]]
                vals, idx = orig(U, V, mask, k, **kw)
                idx[0, 0] = (idx[0, 0] + 1) % V.shape[1]
                return vals, idx
            return topk
        return _patched(ops, "recommend_topk_peruser", make)
    if fault == "state_unchanged":
        return _patched(dmf, "scatter_add_rows_", lambda orig: lambda target, idx, vals: target)
    if fault == "half_batch":
        def make(orig):
            def update(U, P, Q, nbr_idx, nbr_wgt, ui, vj, r, conf, cfg, *a, **kw):
                h = ui.shape[0] // 2
                return 2.0 * orig(U, P, Q, nbr_idx, nbr_wgt, ui[:h], vj[:h], r[:h], conf[:h],
                                  cfg, *a, **kw)
            return update
        return _patched(dmf, "_sparse_batch_update", make)

    def make(orig):
        def step(*a, **kw):
            du, gp, dq, loss = orig(*a, **kw)
            return du, gp, dq, loss * 1.01
        return step
    return _patched(ops, "dmf_fused_step", make)
