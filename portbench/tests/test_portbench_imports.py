"""What a run loads: no module whose top-level name (the part before the
first dot, compared whole) is JAX's, Flax's or the JAX package's, and a
reference that loads nothing of the program. Each is read in a fresh
process, since this one may hold JAX for other tests."""
import json
import os
import subprocess
import sys

import pytest

from portbench.manifest import ROOT

JAXLIKE = {"jax", "jaxlib", "flax", "repro"}


def _top_level_after(code: str) -> set[str]:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "src")])}
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


RUN = """
from portbench.manifest import Manifest
from portbench.runner import run_cell
from portbench.tests import _tiny
for cell, kind in sorted(_tiny.KIND.items()):
    for trace in (False, True):
        run_cell(cell, 3, 0.2, trace, device="cpu", config_overrides=_tiny.CONFIG,
                 traffic_overrides=_tiny.TRAFFIC[kind], manifest=Manifest(pending=True))
import portbench.control, portbench.faults, portbench.run
"""


def test_a_run_loads_no_jax_and_not_the_jax_package():
    names = _top_level_after(RUN)
    assert "repro_torch" in names and "torch" in names
    assert not names & JAXLIKE, sorted(names & JAXLIKE)


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_after("import portbench.reference.dmf, portbench.compare, "
                             "portbench.data.synthetic_poi, portbench.counts")
    assert "repro_torch" not in names
    assert not names & JAXLIKE


@pytest.mark.parametrize("loaded,found", [("json", []), ("jax.numpy", ["jax.numpy"]),
                                          ("repro.core", ["repro.core"]),
                                          ("repro_torch.core", [])])
def test_forbidden_modules_compares_whole_top_level_names(loaded, found, monkeypatch):
    from portbench import run
    mods = {"json": sys.modules["json"], loaded: object()}
    monkeypatch.setattr(run.sys, "modules", mods)
    assert run.forbidden_modules() == found
