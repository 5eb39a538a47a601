"""The readings that the limits of a cell's check are set from, at the
cell's own size:

- ``sound``: the program as the benchmark runs it, one seed after another
  (a short window each for refresh; the checked job alone for training);
- ``control``: the reference put in the program's place in the nearest
  precision below float32 (TF32 factors for the slates, bfloat16 state
  and arithmetic for training), judged by the same comparison;
- one entry a fault of `faults.py` that the cell's traffic can have,
  planted in the program.

    python3 portbench/control.py --workload alipay.refresh --seeds 1-12 \
        --control-seeds 1-3 --fault-seeds 1-3

Reads the cells of `BENCHMARK.json` and of ``pending.json``. Prints one
JSON line a reading (a 2-s window for each refresh seed) and a last line
with, for each number, the largest sound reading and the smallest reading
of the control and of each fault. Needs a CUDA card; the tests call
`readings` on the CPU at small sizes.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import compare, faults  # noqa: E402
from portbench.data import synthetic_poi  # noqa: E402
from portbench.manifest import Manifest  # noqa: E402
from portbench.reference import dmf as ref  # noqa: E402
from portbench.runner import device_of  # noqa: E402
from portbench.seeds import sub_seed  # noqa: E402


def _dataset(config: dict):
    data = dict(config["dataset"])
    return synthetic_poi.generate({k: v for k, v in data.items() if k != "seed"}, data["seed"])


def _refresh_control(config, traffic, seed, dev) -> dict:
    from portbench.loops.refresh import served_factors
    ds = _dataset(config)
    U, P, Q = served_factors(seed, ds.n_users, ds.n_items, config["model"]["dim"],
                             config["served_scale"], dev)
    k = traffic["k"]
    seen = ref.seen_mask(ds.train, ds.n_users, ds.n_items, dev)
    vals, ids, _ = ref.slate_truth(U, P, Q, seen, k, tf32=True)
    vals, ids = vals.float().cpu().numpy(), ids.to(torch.int32).cpu().numpy()
    cold = np.ones(ds.n_users, bool)
    cold[np.unique(ds.train[:, 0])] = False
    vals[cold], ids[cold] = ref.popularity(ds.train, ds.n_items, k)[::-1]
    return compare.judge_slates((np.arange(ds.n_users), vals, ids), U, P, Q, ds.train, k)


def _train_control(config, traffic, seed, dev, table, ds) -> dict:
    args = (ds.train, table, dict(config["model"]), ds.n_items, seed, traffic["batch_size"],
            traffic["check_epochs"])
    want = ref.train_job(*args, dtype=torch.float32, device=dev)
    got = ref.train_job(*args, dtype=torch.bfloat16, device=dev)
    for r in (want, got):
        r["norms"] = [r["norms"][0], r["norms"][-1]]
    return compare.judge_training(got, want)


def readings(workload: str, seeds, control_seeds, fault_seeds, seconds: float, device: str,
             config_overrides=None, traffic_overrides=None, manifest=None):
    """Yield (what, seed, readings) for the sound runs, the control and
    every fault of the cell's traffic."""
    man = manifest or Manifest(pending=True)
    config = man.config(workload, config_overrides)
    traffic = man.traffic(workload, traffic_overrides)
    kind = traffic["loop"]
    Bench = man.loop(kind).Bench
    dev = device_of(device)
    if kind == "refresh":
        def sound(s):
            b = Bench(config, traffic, s, dev)
            b.run_window(seconds, False)
            b.free()
            return b.judge()
        for s in seeds:
            yield "sound", s, sound(s)
        for s in control_seeds:
            yield "control", s, _refresh_control(config, traffic, s, dev)
        for fault in faults.FAULTS[kind]:
            for s in fault_seeds:
                with faults.planted(kind, fault):
                    r = sound(s)
                yield fault, s, r
        return
    b = Bench(config, traffic, seeds[0], dev)

    def sound(s):
        b.seed = s
        b.run_window(0.0, False)         # the checked job alone
        return b.judge()
    for s in seeds:
        r = sound(s)
        print(json.dumps({"workload": workload, "seed": s, "reference": b.reference}), flush=True)
        yield "sound", s, r
    table = ref.neighbor_table(b.ds.user_coords, b.ds.user_city, config["graph"], dev)
    for s in control_seeds:
        yield "control", s, _train_control(config, traffic, sub_seed(s, "jobs", 0), dev, table,
                                           b.ds)
    del table
    for fault in faults.FAULTS[kind]:
        for s in fault_seeds:
            with faults.planted(kind, fault):
                r = sound(s)
            yield fault, s, r


def summary(rows) -> dict:
    """For each number: the largest sound reading, and the smallest of the
    control and of each fault."""
    out: dict = {}
    for what, _, r in rows:
        for name, v in r.items():
            d = out.setdefault(name, {})
            if what == "sound":
                d["sound_max"] = max(d.get("sound_max", -np.inf), v)
            else:
                d[f"{what}_min"] = min(d.get(f"{what}_min", np.inf), v)
    return out


def _seeds(text: str) -> list[int]:
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b) + 1) if b else [int(a)])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for what, s, r in readings(args.workload, args.seeds, args.control_seeds, args.fault_seeds,
                               2.0, "cuda"):
        rows.append((what, s, r))
        print(json.dumps({"workload": args.workload, "what": what, "seed": s, **r}), flush=True)
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
