"""The port's examples (`python -m repro_torch.examples.quickstart`,
`python -m repro_torch.examples.poi_serving`, and the LM examples
`train_lm` and `decentralized_lm` at a tiny size) on the CPU
(``--device cpu``). The quickstart prints the reference's
`examples/quickstart.py` lines, run in this process: the same dataset and
graph lines, the same losses and DMF and MF P@k/R@k to the 4 digits both
print, and its "DMF should beat centralized MF" assertion holds. The
serving example prints the reference's `examples/poi_serving.py` lines,
run in this process with the same flags, all but the timing line: the
candidate index, P@10, the sample slate, the spot check's and the
fallback's counts and the online refresh's line. Its own checks pass:
its engine equals the plain dense top-k of `kernels/ref.py` on the
spot-checked requests, ids and values exactly, and the online refresh
lowers the loss on the streamed events. `train_lm` prints the reference's
lines and writes the reference's snapshots; `decentralized_lm` runs both
syncs. Without ``--device`` all four run on the card and raise without
one.
"""
import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

from repro_torch.examples import decentralized_lm, poi_serving, quickstart, train_lm

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
REF_QUICKSTART = EXAMPLES / "quickstart.py"
REF_POI_SERVING = EXAMPLES / "poi_serving.py"
REF_TRAIN_LM = EXAMPLES / "train_lm.py"
TINY_LM = ["--steps", "25", "--d-model", "64", "--n-layers", "1", "--seq-len", "16",
           "--batch", "2", "--vocab", "128", "--ckpt-every", "10"]
# the reference's spot-check values differ from its oracle's by about one
# ulp on this jax (ROADMAP §C2): the port's bar for that fault
C2_TOL = 1e-6


def test_quickstart_prints_the_reference_lines(capsys):
    pytest.importorskip("jax")
    got = quickstart.main(["--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    runpy.run_path(str(REF_QUICKSTART), run_name="__main__")
    ref_lines = capsys.readouterr().out.splitlines()
    assert port_lines == ref_lines
    assert [ln for ln in port_lines if ln.startswith(("DMF:", "MF :"))] == [
        "DMF: " + str({k: round(v, 4) for k, v in got["DMF"].items()}),
        "MF : " + str({k: round(v, 4) for k, v in got["MF"].items()})]
    assert got["DMF"]["R@10"] > got["MF"]["R@10"]


def reference_poi_serving_lines(monkeypatch, capsys) -> list[str]:
    """`examples/poi_serving.py`'s lines, run in this process with its
    default flags. Where its own exact spot check of the values fails by
    §C2's ulp (ids equal, values within 1e-6), its remaining two lines are
    printed here from its `main`'s own objects, as its code prints them."""
    monkeypatch.setattr(sys, "argv", [str(REF_POI_SERVING)])
    try:
        runpy.run_path(str(REF_POI_SERVING), run_name="__main__")
        return capsys.readouterr().out.splitlines()
    except AssertionError as e:
        if str(e) != "engine values != oracle":
            raise
        tb = e.__traceback__
        while tb.tb_frame.f_code.co_name != "main":
            tb = tb.tb_next
        f = tb.tb_frame.f_locals
        glob = tb.tb_frame.f_globals
    args, warm, flags, engine = f["args"], f["warm"], f["flags"], f["engine"]
    np.testing.assert_array_equal(f["recs"][:16][warm], np.asarray(f["i_ref"])[warm])
    np.testing.assert_allclose(f["vals"][:16][warm], np.asarray(f["v_ref"])[warm],
                               rtol=C2_TOL, atol=C2_TOL)
    print(f"engine == dense oracle on {int(warm.sum())}/16 factor-scored "
          f"requests (indices and values): OK; "
          f"{int(flags.sum())}/{args.requests} requests served the flagged "
          f"popularity fallback")
    events = f["ds"].test[: min(64, len(f["ds"].test))]
    before = glob["dmf"].test_loss(engine.state, events)
    report = engine.ingest(events, glob["OnlineConfig"](steps=3))
    after = glob["dmf"].test_loss(engine.state, events)
    print(f"online refresh: {report.n_events} check-ins, "
          f"{len(report.affected_users)} users affected, "
          f"{len(report.touched_users)} factor rows touched; "
          f"loss on streamed events {before:.4f} -> {after:.4f}")
    assert after < before
    return capsys.readouterr().out.splitlines()


def test_poi_serving_checks_pass_on_the_cpu(monkeypatch, capsys):
    pytest.importorskip("jax")
    got = poi_serving.main(["--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    ref_lines = reference_poi_serving_lines(monkeypatch, capsys)

    def untimed(lines):
        return [ln for ln in lines if " req/s, p50=" not in ln]
    assert len(untimed(port_lines)) == len(port_lines) - 1
    assert untimed(port_lines) == untimed(ref_lines)
    assert "engine == dense oracle on" in port_lines[-2] and ": OK;" in port_lines[-2]
    assert got["spot_checked"] > 0
    assert got["loss_after"] < got["loss_before"]


@pytest.fixture
def one_thread():
    """One intra-op thread for the LM examples' small tensors: with every
    core busy (the suite runs its files in parallel) each parallel region
    waits for its threads (a 2 s run took 188 s at 8 threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
def test_train_lm_prints_the_reference_lines(monkeypatch, capsys, tmp_path):
    """`train_lm` at a tiny size: the reference's arch line (the same
    parameter count), a step line at the reference's steps, its
    checkpoint line; the port's snapshots are the reference's (the same
    steps, leaf names, shapes and dtypes in the manifests). The weights
    are drawn from each package's own seeded generator, so the losses
    differ; the port's must fall."""
    pytest.importorskip("jax")
    import json
    got = train_lm.main(TINY_LM + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")])
    port_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", [str(REF_TRAIN_LM), *TINY_LM,
                                      "--ckpt-dir", str(tmp_path / "ref")])
    runpy.run_path(str(REF_TRAIN_LM), run_name="__main__")
    ref_lines = capsys.readouterr().out.splitlines()
    assert port_lines[0] == ref_lines[0] == "arch=qwen1.5-4b params=0.1M layers=1 d=64"
    steps = lambda lines: [ln.split()[1] for ln in lines if ln.startswith("step ")]
    assert steps(port_lines) == steps(ref_lines) == ["0", "20", "24"]
    assert port_lines[-1] == f"checkpoints in {tmp_path / 'port'}; latest step 25"
    assert ref_lines[-1] == f"checkpoints in {tmp_path / 'ref'}; latest step 25"
    assert got["losses"][-1][1] < got["losses"][0][1]
    for snap in ("step_10", "step_20", "step_25"):
        manifests = [json.loads((tmp_path / side / snap / "manifest.json").read_text())
                     for side in ("port", "ref")]
        assert manifests[0]["step"] == manifests[1]["step"]
        strip = lambda m: {k: (v["shape"], v["dtype"]) for k, v in m["leaves"].items()}
        assert strip(manifests[0]) == strip(manifests[1])


@pytest.mark.usefixtures("one_thread")
def test_decentralized_lm_runs_both_syncs_on_the_cpu(capsys):
    """`decentralized_lm` at 11 steps: the reference's lines for allreduce
    and gossip (the reference's own run needs a mesh of 8 devices, whose
    lowering fails on this jax: ROADMAP §C3); both losses fall, the
    learners stay near consensus."""
    got = decentralized_lm.main(["--device", "cpu", "--steps", "11"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln[:22] for ln in lines if ln.startswith("[")] == [
        "[allreduce] step   0 l", "[allreduce] step  10 l",
        "[gossip   ] step   0 l", "[gossip   ] step  10 l"]
    assert all("consensus_err=" in ln for ln in lines if ln.startswith("[gossip"))
    assert lines[-2].startswith("final loss: allreduce=")
    assert lines[-1].startswith("gossip-vs-centralized gap: ")
    for curve in got["curves"].values():
        assert len(curve) == 11 and curve[-1] < curve[0] - 0.3
    assert got["consensus_err"] < 0.5


@pytest.mark.parametrize("example", [quickstart, poi_serving, train_lm, decentralized_lm],
                         ids=["quickstart", "poi_serving", "train_lm", "decentralized_lm"])
def test_examples_default_to_the_card_and_raise_without_one(monkeypatch, example):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        example.main([])
