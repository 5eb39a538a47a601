"""`BENCHMARK.json` against the benchmark's contract, and every file it
names found by name."""
import json
import pathlib
import re

import pytest

from portbench.manifest import HERE, ROOT, Manifest

MAN = Manifest()
DOC = MAN.doc
ALL = Manifest(pending=True)            # with the cells of pending.json
PENDING = json.loads((HERE / "pending.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in DOC["workloads"]]
ALL_CELLS = [w["name"] for w in ALL.doc["workloads"]]


def test_top_level_keys_and_command():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert DOC["command"] == ["python3", "portbench/run.py"]
    assert len(DOC["command"]) <= 32
    for p in DOC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(DOC["paths"]) <= 16
    assert isinstance(DOC["run_seconds"], int) and 1 <= DOC["run_seconds"] <= 51
    assert len(json.dumps(DOC).encode()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits():
    rs = DOC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _entries():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in ALL.doc[group]:
            yield pytest.param(group, e, id=f"{group}:{e['name']}")


@pytest.mark.parametrize("group,entry", list(_entries()))
def test_entry_keys_and_characters(group, entry):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[group]
    extra = set(entry) - keys
    assert extra <= ({"workloads"} if group in ("end_to_end", "per_layer") else set())
    assert keys <= set(entry)
    assert NAME.match(entry["name"])
    for text in ("why", "layer", "source"):
        if text in entry and group in ("configs", "workloads", "per_layer"):
            v = entry[text]
            assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v
    if group in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    if group == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if group == "per_layer":
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
        if entry["unit"] == "%" and "roofline" in entry["name"]:
            assert entry["name"].endswith("_roofline")
    if group == "workloads":
        assert entry["chips"] == 1
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
    if group == "configs":
        assert entry["reduced"] == [] and PATH.match(entry["file"])


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in ALL.doc[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in ALL.doc["end_to_end"] + ALL.doc["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in ALL.doc["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_pending_cells_are_not_in_the_benchmark_and_use_its_configs():
    assert set(PENDING) == {"why", "workloads", "end_to_end", "per_layer"}
    names = {w["name"] for w in PENDING["workloads"]}
    assert names and not names & set(CELLS)
    assert {w["config"] for w in PENDING["workloads"]} <= {c["name"] for c in DOC["configs"]}
    for m in PENDING["end_to_end"] + PENDING["per_layer"]:
        assert set(m["workloads"]) <= names


@pytest.mark.parametrize("metric", ALL.doc["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_an_end_to_end_metric_of_all_its_cells(metric):
    e2e = {m["name"]: m for m in ALL.doc["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric["workloads"]:
        assert cell in ALL_CELLS
        assert metric["moves"] in {m["name"] for m in ALL.end_to_end(cell)}


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in ALL.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert ALL.per_layer(cell)


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_cell_files_found_by_name(cell):
    config = ALL.config(cell)
    traffic = ALL.traffic(cell)
    limits = ALL.limits(cell)
    assert config["name"] == ALL.cell(cell)["config"]
    assert ALL.loop(traffic["loop"]).Bench
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    # the configuration states the sizes its traffic uses
    assumed = config["assumed"]
    if traffic["loop"] == "train":
        assert traffic["batch_size"] == assumed["round_size"]
    else:
        assert traffic["microbatch"] == assumed["refresh_microbatch"]


@pytest.mark.parametrize("metric", ALL.doc["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    reader = MAN.reader(metric["name"])
    assert callable(reader.read)
    assert reader.read({}, None) is None       # nothing to read: no number


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in DOC["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(DOC["paths"][0] + "/") and (ROOT / f).is_file()


def test_every_file_under_paths_is_named_from_name_characters():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
        assert pathlib.PurePosixPath(rel).name[0] not in "-."
