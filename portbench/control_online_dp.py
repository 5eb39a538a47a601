"""The readings that the limits of the private online cell
(``foursquare.ingest_refresh_dp``) are set from, at the cell's own size:

- ``sound``: the program as the benchmark runs it, one seed after another
  (a short window each);
- ``tf32``: the DP reference replayed in float32 with its state rounded to
  TF32 after every batch (the nearest precision below float32) in the
  program's place, its factors judged against the float64 replay by the
  same comparison;
- one entry a fault of `FAULTS`, planted in the program for the run:
  ``noise_left_out`` (σ read as 0: clip only), ``clip_left_out`` (kernel 8
  called with C = ∞: noise only), ``seed_reused`` (every round after the
  first releases under the first round's mechanism seed, its fresh draw
  made and dropped), ``seed_unfolded`` (the round's draw alone, ``dp_seed``
  not folded in) and ``noise_on_padded`` (the padded rows' noised
  messages not zeroed again). At the cell's 512 check-ins a step fills 8
  batches exactly and no row is padded, so that fault runs at
  ``PADDED_EVENTS`` check-ins a round (48 padded rows a step), where it
  has rows to act on; every other run is at the cell's traffic.

    python3 portbench/control_online_dp.py --seeds 1-6 --control-seeds 1-2 --fault-seeds 1-2

Prints one JSON line a reading and a last line with, for each number, the
largest sound reading and the smallest of the control and of each fault
(`control.summary`). Needs a CUDA card; the tests call `readings` on the
CPU at small sizes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench.control import _seeds, summary  # noqa: E402
from portbench.data import synthetic_poi  # noqa: E402
from portbench.loops import ingest_refresh as base  # noqa: E402
from portbench.loops import ingest_refresh_dp as loop  # noqa: E402
from portbench.loops.refresh import served_factors  # noqa: E402
from portbench.manifest import Manifest  # noqa: E402
from portbench.reference import dmf as ref_dmf  # noqa: E402
from portbench.reference import online_dp as ref_online_dp  # noqa: E402
from portbench.runner import device_of  # noqa: E402

WORKLOAD = "foursquare.ingest_refresh_dp"
FAULTS = ("noise_left_out", "clip_left_out", "seed_reused", "seed_unfolded", "noise_on_padded")
PADDED_EVENTS = 500


@contextlib.contextmanager
def planted(fault: str):
    """Plant ``fault`` in the program for the ``with`` block (one name of
    `privacy/mechanism.py`, `kernels/ops.py` or `core/dmf.py` patched,
    then put back)."""
    from repro_torch.core import dmf
    from repro_torch.kernels import ops
    from repro_torch.privacy import mechanism

    if fault == "noise_left_out":
        module, name = mechanism, "noise_std"

        def make(orig):
            return lambda cfg: 0.0
    elif fault == "clip_left_out":
        module, name = ops, "dp_clip_noise"

        def make(orig):
            def clip_noise(g, rid, seed, *, clip, noise_std):
                return orig(g, rid, seed, clip=float("inf"), noise_std=noise_std)
            return clip_noise
    elif fault == "seed_reused":
        module, name = mechanism, "epoch_noise_seed"

        def make(orig):
            first = []

            def seed(rng, cfg):
                s = orig(rng, cfg)
                if not first:
                    first.append(s)
                return first[0]
            return seed
    elif fault == "seed_unfolded":
        module, name = mechanism, "epoch_noise_seed"

        def make(orig):
            return lambda rng, cfg: orig(rng, dataclasses.replace(cfg, dp_seed=0))
    elif fault == "noise_on_padded":
        module, name = dmf, "_dp_message"

        def make(orig):
            return lambda gp, rid, dp_seed, cfg, valid=None: orig(gp, rid, dp_seed, cfg)
    else:
        raise ValueError(f"no fault {fault!r} (have {FAULTS})")
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def tf32_control(config: dict, traffic: dict, seed: int, dev) -> dict:
    """``factor_gap`` and ``untouched_moved`` of the TF32 DP replay of the
    warm-up and the checked rounds against the float64 DP replay, the
    largest and the sum over the checked rounds, on the inputs the cell
    draws from ``seed``."""
    data = dict(config["dataset"])
    ds = synthetic_poi.generate({k: v for k, v in data.items() if k != "seed"}, data["seed"])
    draw = base.Draw(ds, traffic["events_per_round"])
    table = ref_dmf.neighbor_table(ds.user_coords, ds.user_city, config["graph"], dev)
    initial = served_factors(seed, ds.n_users, ds.n_items, config["model"]["dim"],
                             config["served_scale"], dev)
    args = (*initial, table, dict(config["model"]), dict(config["online"]),
            base.engine_seed(seed), config["dp"], loop.dp_seed(seed))
    want = ref_online_dp.replay(*args)
    got = ref_online_dp.replay(*args, dtype=torch.float32, tf32=True)
    out = {"factor_gap": 0.0, "untouched_moved": 0.0}
    for r in range(traffic["check_rounds"] + 1):
        events = draw.round(seed, r)
        want.round(events)
        got.round(events)
        if r:
            gap, moved = base.factor_readings((got.U, got.P, got.Q), want, initial)
            out["factor_gap"] = max(out["factor_gap"], gap)
            out["untouched_moved"] += moved
    return out


def readings(seeds, control_seeds, fault_seeds, seconds: float, device: str,
             config_overrides=None, traffic_overrides=None, manifest=None):
    """Yield (what, seed, readings) for the sound runs, the control and
    each fault. A sound run's readings add ``clipped_share``: the share of
    the replay's released messages whose norm exceeded C, in percent."""
    man = manifest or Manifest()
    config = man.config(WORKLOAD, config_overrides)
    traffic = man.traffic(WORKLOAD, traffic_overrides)
    padded = {**traffic, "events_per_round": PADDED_EVENTS}
    dev = device_of(device)

    def run(s, tr=traffic):
        b = loop.Bench(config, tr, s, dev)
        b.run_window(seconds, False)
        b.free()
        r = b.judge()
        released, clipped = b.replayed
        return {**r, "clipped_share": 100.0 * clipped / released}
    for s in seeds:
        yield "sound", s, run(s)
    for s in control_seeds:
        yield "tf32", s, tf32_control(config, traffic, s, dev)
    for fault in FAULTS:
        for s in fault_seeds:
            with planted(fault):
                r = run(s, padded if fault == "noise_on_padded" else traffic)
            yield fault, s, r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control_online_dp: no CUDA card", file=sys.stderr)
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
