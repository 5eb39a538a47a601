"""The readings that the limits of the online cell
(``foursquare.ingest_refresh``) are set from, at the cell's own size:

- ``sound``: the program as the benchmark runs it, one seed after another
  (a short window each);
- ``tf32``: the reference replayed in float32 with its state rounded to
  TF32 after every batch (the nearest precision below float32) in the
  program's place, its factors judged against the float64 replay by the
  same comparison;
- one entry a fault of `FAULTS`, planted in the program for the run:
  ``receiver_unscattered`` (the P scatter leaves out each sender's last
  walk receiver other than itself), ``receiver_unrefreshed`` (the
  refreshed set drops one receiver that sent nothing, each round) and
  ``entry_moved`` (each round also moves one P entry of a user the round
  did not touch).

    python3 portbench/control_online.py --seeds 1-6 --control-seeds 1-2 --fault-seeds 1-2

Prints one JSON line a reading and a last line with, for each number, the
largest sound reading and the smallest of the control and of each fault
(`control.summary`). Needs a CUDA card; the tests call `readings` on the
CPU at small sizes.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.control import _seeds, summary  # noqa: E402
from portbench.data import synthetic_poi  # noqa: E402
from portbench.loops import ingest_refresh as loop  # noqa: E402
from portbench.loops.refresh import served_factors  # noqa: E402
from portbench.manifest import Manifest  # noqa: E402
from portbench.reference import dmf as ref_dmf  # noqa: E402
from portbench.reference import online as ref_online  # noqa: E402
from portbench.runner import device_of  # noqa: E402

WORKLOAD = "foursquare.ingest_refresh"
FAULTS = ("receiver_unscattered", "receiver_unrefreshed", "entry_moved")


@contextlib.contextmanager
def planted(fault: str):
    """Plant ``fault`` in the program for the ``with`` block (one name of
    `core/dmf.py` or `serving/online.py` patched, then put back)."""
    from repro_torch.core import dmf
    from repro_torch.serving import online

    if fault == "receiver_unscattered":
        module, name = dmf, "_sparse_batch_update"

        def make(orig):
            def update(U, P, Q, nbr_idx, nbr_wgt, ui, *a, **kw):
                rows = torch.arange(nbr_idx.shape[0], device=nbr_idx.device)[:, None]
                other = (nbr_wgt > 0) & (nbr_idx != rows)
                slot = torch.arange(nbr_idx.shape[1], device=nbr_idx.device)
                last = torch.where(other, slot, -1).amax(1)       # -1: none but itself
                drop = (slot == last[:, None]) & other
                return orig(U, P, Q, nbr_idx, nbr_wgt.masked_fill(drop, 0.0), ui, *a, **kw)
            return update
    elif fault == "receiver_unrefreshed":
        module, name = online, "touched_from_events"

        def make(orig):
            def touched(events, nbr):
                affected, users = orig(events, nbr)
                quiet = np.setdiff1d(users, affected)
                if len(quiet):
                    users = users[users != quiet[-1]]
                return affected, users
            return touched
    elif fault == "entry_moved":
        module, name = online, "online_refresh"

        def make(orig):
            def refresh(state, nbr, events, *a, **kw):
                state, report = orig(state, nbr, events, *a, **kw)
                untouched = np.setdiff1d(np.arange(state.P.shape[0]), report.touched_users)
                state.P[int(untouched[0]), 0, 0] += 1e-3
                return state, report
            return refresh
    else:
        raise ValueError(f"no fault {fault!r} (have {FAULTS})")
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def tf32_control(config: dict, traffic: dict, seed: int, dev) -> dict:
    """``factor_gap`` and ``untouched_moved`` of the TF32 replay of the
    warm-up and the checked rounds against the float64 replay, the largest
    and the sum over the checked rounds, on the inputs the cell draws from
    ``seed``."""
    data = dict(config["dataset"])
    ds = synthetic_poi.generate({k: v for k, v in data.items() if k != "seed"}, data["seed"])
    draw = loop.Draw(ds, traffic["events_per_round"])
    table = ref_dmf.neighbor_table(ds.user_coords, ds.user_city, config["graph"], dev)
    initial = served_factors(seed, ds.n_users, ds.n_items, config["model"]["dim"],
                             config["served_scale"], dev)
    args = (*initial, table, dict(config["model"]), dict(config["online"]),
            loop.engine_seed(seed))
    want = ref_online.replay(*args)
    got = ref_online.replay(*args, dtype=torch.float32, tf32=True)
    out = {"factor_gap": 0.0, "untouched_moved": 0.0}
    for r in range(traffic["check_rounds"] + 1):
        events = draw.round(seed, r)
        want.round(events)
        got.round(events)
        if r:
            gap, moved = loop.factor_readings((got.U, got.P, got.Q), want, initial)
            out["factor_gap"] = max(out["factor_gap"], gap)
            out["untouched_moved"] += moved
    return out


def readings(seeds, control_seeds, fault_seeds, seconds: float, device: str,
             config_overrides=None, traffic_overrides=None, manifest=None):
    """Yield (what, seed, readings) for the sound runs, the control and
    each fault."""
    man = manifest or Manifest()
    config = man.config(WORKLOAD, config_overrides)
    traffic = man.traffic(WORKLOAD, traffic_overrides)
    dev = device_of(device)

    def run(s):
        b = loop.Bench(config, traffic, s, dev)
        b.run_window(seconds, False)
        b.free()
        return b.judge()
    for s in seeds:
        yield "sound", s, run(s)
    for s in control_seeds:
        yield "tf32", s, tf32_control(config, traffic, s, dev)
    for fault in FAULTS:
        for s in fault_seeds:
            with planted(fault):
                r = run(s)
            yield fault, s, r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control_online: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for what, s, r in readings(args.seeds, args.control_seeds, args.fault_seeds, args.seconds,
                               "cuda"):
        rows.append((what, s, r))
        print(json.dumps({"workload": WORKLOAD, "what": what, "seed": s, **r}), flush=True)
    print(json.dumps({"workload": WORKLOAD, "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
