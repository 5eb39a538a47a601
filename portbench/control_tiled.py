"""The readings that the limits of the tiled int8 refresh cell
(``million.refresh_int8``) are set from, at the cell's own size:

- ``sound``: the program as the benchmark runs it, one seed after another
  (a short window each);
- ``fp32_window`` and ``bf16_window``: the reference's slates from the
  unquantized float32 window and from the bfloat16 window put in the
  program's place, judged against the int8 truth by the same comparison;
- ``code_moved``: the fault of one int8 code of the program's store moved
  by 1 (the code of the factor with the largest |u| of the first warm
  user's top POI), planted after set-up.

With control seeds it also prints, a seed, the users whose int8 scale
their window's padding sets (`padding_widening`).

    python3 portbench/control_tiled.py --seeds 1-6 --control-seeds 1-2 --fault-seeds 1-2

Prints one JSON line a reading and a last line with, for each number, the
largest sound reading and the smallest of each control and of the fault
(`control.summary`). Needs a CUDA card; the tests call `readings` on the
CPU at small sizes.
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

from portbench.control import _seeds, summary  # noqa: E402
from portbench.data import synthetic_world  # noqa: E402
from portbench.loops import tiled_refresh  # noqa: E402
from portbench.manifest import Manifest  # noqa: E402
from portbench.reference import tiled as ref  # noqa: E402
from portbench.runner import device_of  # noqa: E402

WORKLOAD = "million.refresh_int8"
WINDOWS = ("fp32", "bf16")


def _inputs(config: dict, seed: int, dev) -> ref.Reference:
    """The reference over the inputs the cell draws from ``seed``."""
    w, sv = config["world"], config["serving"]
    I, J, K = w["n_users"], w["n_items"], config["model"]["dim"]
    world = synthetic_world.generate(I, J, w["n_cities"], w["seed"], w["zipf_a"],
                                     w["city_sigma"])
    uc, ic, ucoord, icoord = world
    split = ref.cells(ic, uc, icoord, ucoord, sv["cell_cap"])
    factors = tiled_refresh.draw_factors(seed, I, J, K)
    checkins = tiled_refresh.draw_checkins(seed, split, sv["seen_per_user"])
    return ref.Reference(world, factors, checkins, cell_cap=sv["cell_cap"], pad_to=sv["pad_to"],
                         k=sv["k"], device=dev, split=split)


def window_control(config: dict, seed: int, precision: str, dev) -> dict:
    """The reference's slates from the window in ``precision``, judged
    against its int8 truth, on the inputs the cell draws from ``seed``."""
    r = _inputs(config, seed, dev)
    return r.judge([r.serve(precision)])


def padding_widening(r: ref.Reference) -> dict:
    """The users whose int8 scale their padding columns (POI 0's view) set,
    and how much wider it is than their cell's POIs alone would give."""
    n, widest = 0, 0.0
    for a in range(0, r.I, r.block):
        b = min(a + r.block, r.I)
        items, _, _, _, v = r._block(a, b, "fp32")
        cell = v.abs().masked_fill((items >= r.J)[..., None], 0.0).amax(dim=(1, 2))
        pad = (r.B1[0] * r.s[a:b, None] + r.B2[0]).abs().amax(1)
        wider = (r.size[r.cell_u[a:b]] < r.cap) & (pad > cell)
        n += int(wider.sum())
        if wider.any():
            widest = max(widest, float((pad[wider] / cell[wider]).max()) - 1.0)
    return {"users": n, "of": r.I, "widest": widest}


def move_code(bench) -> tuple[int, int, int]:
    """Move one int8 code of the bench's store by 1: in the first user not
    served the popularity slate, at the column of the user's top POI, the
    factor where |u| is largest. Returns (user, column, factor)."""
    eng = bench.engine
    st = eng.store
    for u in range(st.n_users):
        _, idx, flags = eng.recommend(np.array([u]), return_flags=True)
        if not flags[0] and idx[0, 0] >= 0:
            break
    window = st.index.bucket_items[st.index.user_bucket[u]]
    c = int(np.flatnonzero(window == idx[0, 0])[0])
    f = int(st.U[u].abs().argmax())
    code = int(st.q_codes[u, c, f])
    st.q_codes[u, c, f] = code + (1 if code < 127 else -1)
    eng.stats.reset()
    return int(u), c, f


def readings(seeds, control_seeds, fault_seeds, seconds: float, device: str,
             config_overrides=None, traffic_overrides=None, manifest=None):
    """Yield (what, seed, readings) for the sound runs, each window
    control and the fault."""
    man = manifest or Manifest()
    config = man.config(WORKLOAD, config_overrides)
    traffic = man.traffic(WORKLOAD, traffic_overrides)
    dev = device_of(device)

    def run(s, plant=None):
        b = tiled_refresh.Bench(config, traffic, s, dev)
        if plant is not None:
            plant(b)
        b.run_window(seconds, False)
        b.free()
        return b.judge()
    for s in seeds:
        yield "sound", s, run(s)
    for precision in WINDOWS:
        for s in control_seeds:
            yield f"{precision}_window", s, window_control(config, s, precision, dev)
    for s in fault_seeds:
        yield "code_moved", s, run(s, move_code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control_tiled: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for what, s, r in readings(args.seeds, args.control_seeds, args.fault_seeds, 2.0, "cuda"):
        rows.append((what, s, r))
        print(json.dumps({"workload": WORKLOAD, "what": what, "seed": s, **r}), flush=True)
    print(json.dumps({"workload": WORKLOAD, "summary": summary(rows)}), flush=True)
    config = Manifest().config(WORKLOAD)
    for s in args.control_seeds:
        print(json.dumps({"workload": WORKLOAD, "what": "padding", "seed": s,
                          **padding_widening(_inputs(config, s, torch.device("cuda")))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
