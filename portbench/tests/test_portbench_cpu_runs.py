"""A small run of each cell on the CPU through the program's plain-kernel
path, its last line as the contract has it; and the command's refusals."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from portbench.manifest import ROOT, Manifest
from portbench.runner import run_cell
from portbench.tests import _tiny

MAN = Manifest(pending=True)     # the training cells are pending


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(_tiny.KIND))
def test_small_cpu_run_prints_the_contract_line(cell, trace):
    result, lines = run_cell(cell, 2 ** 31 + 17, 0.6, bool(trace), device="cpu", manifest=MAN,
                             config_overrides=_tiny.CONFIG,
                             traffic_overrides=_tiny.TRAFFIC[_tiny.KIND[cell]])
    line = json.loads(json.dumps(result))
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    want = {m["name"] for m in (MAN.per_layer(cell) if trace else MAN.end_to_end(cell))}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    else:   # no device events on the CPU: the trace readers find nothing
        assert all(m in ("epoch_p95_ms.train",) for m in line["metrics"])
    for m in line["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    assert set(line["checks"]) == set(MAN.limits(cell)) | {"failed"}
    assert lines == [f"check {n} {c['value']!r} limit {c['limit']!r}"
                     for n, c in result["checks"].items()]


def test_same_seed_same_inputs():
    args = ("alipay.refresh", 12345, 0.2, False)
    kw = dict(device="cpu", config_overrides=_tiny.CONFIG,
              traffic_overrides=_tiny.TRAFFIC["refresh"], manifest=MAN)
    a, _ = run_cell(*args, **kw)
    b, _ = run_cell(*args, **kw)
    assert a["checks"] == b["checks"]


def _cli(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_command_refuses_without_a_card():
    res = _cli(ROOT, "--workload", "alipay.refresh", "--seed", "1", "--seconds", "1")
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA" in res.stderr


def test_command_fails_without_the_program(tmp_path):
    # a directory holding only BENCHMARK.json and the benchmark's files
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, runpy; sys.argv = ['portbench/run.py', '--workload', 'alipay.refresh', "
            "'--seed', '1', '--seconds', '1']; import torch; "
            "torch.cuda.is_available = lambda: True; torch.cuda.device_count = lambda: 1; "
            "runpy.run_path('portbench/run.py', run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "repro_torch" in res.stderr


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        MAN.cell("nope.refresh")
    assert pathlib.Path(ROOT / "portbench" / "run.py").is_file()
