"""`BENCHMARK.json` and the files it names, found by name: a cell's
configuration (its ``file``), its traffic (``traffic/<traffic>.json``),
its limits (``limits/<workload>.json``), the loop of the traffic's kind
(``loops/<kind>.py``) and each per-layer metric's reader
(``metrics/<metric>.py``). A later cell, traffic mix or metric is a new
file beside these, and no existing file changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Manifest:
    """``pending=True`` adds the cells and metrics of ``pending.json``
    (built and proven, not in `BENCHMARK.json` yet) to those it finds."""

    def __init__(self, path: pathlib.Path = ROOT / "BENCHMARK.json", pending: bool = False):
        self.doc = json.loads(pathlib.Path(path).read_text())
        self.root = pathlib.Path(path).resolve().parent
        if pending:
            more = json.loads((HERE / "pending.json").read_text())
            for key in ("workloads", "end_to_end", "per_layer"):
                self.doc[key] = self.doc[key] + more[key]
        self.cells = {w["name"]: w for w in self.doc["workloads"]}
        self.configs = {c["name"]: c for c in self.doc["configs"]}

    def cell(self, workload: str) -> dict:
        if workload not in self.cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(self.cells)})")
        return self.cells[workload]

    def config(self, workload: str, overrides: dict | None = None) -> dict:
        entry = self.configs[self.cell(workload)["config"]]
        return _merge(json.loads((self.root / entry["file"]).read_text()), overrides)

    def traffic(self, workload: str, overrides: dict | None = None) -> dict:
        name = self.cell(workload)["traffic"]
        return _merge(json.loads((HERE / "traffic" / f"{name}.json").read_text()), overrides)

    def limits(self, workload: str) -> dict:
        return json.loads((HERE / "limits" / f"{workload}.json").read_text())["limits"]

    def end_to_end(self, workload: str) -> list[dict]:
        """The cell's end-to-end metrics: those that list it, and those
        that list no cells."""
        return [m for m in self.doc["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        """The cell's per-layer metrics: those that list it, and those that
        list no cells but move an end-to-end metric the cell reports."""
        moves = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.doc["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in moves)]

    @staticmethod
    def loop(kind: str):
        return importlib.import_module(f"portbench.loops.{kind}")

    @staticmethod
    def reader(metric: str):
        """The reader module of ``metric`` (``metrics/<metric>.py``; the
        name may hold dots, so it is loaded from its path)."""
        path = HERE / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
