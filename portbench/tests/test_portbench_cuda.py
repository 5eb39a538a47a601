"""A short cell on the card, as the command runs it (skips without one)."""
import json
import subprocess
import sys

import pytest

from portbench.manifest import ROOT

pytestmark = pytest.mark.cuda


def test_short_cell_on_the_card(card):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "foursquare.refresh",
                          "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"slates_per_s", "refresh_p95_ms", "setup_s"}
