"""The check is shown to fail: a whole small run on the CPU (past the
harness's look for a card) with each fault its cell can have planted in
the program comes out not correct, and so does the control, the reference
in the nearest precision below float32 in the program's place."""
import pytest

from portbench import compare, control, faults
from portbench.manifest import Manifest
from portbench.runner import run_cell
from portbench.tests import _tiny

MAN = Manifest(pending=True)     # the training cells are pending
CASES = [(cell, fault) for cell, kind in sorted(_tiny.KIND.items())
         for fault in faults.FAULTS[kind]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_planted_fault_makes_the_run_not_correct(cell, fault):
    kind = _tiny.KIND[cell]
    with faults.planted(kind, fault):
        result, _ = run_cell(cell, 977, 0.4, False, device="cpu", config_overrides=_tiny.CONFIG,
                             traffic_overrides=_tiny.TRAFFIC[kind], manifest=MAN)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_faults_leave_the_program_as_it_was():
    from repro_torch.core import dmf
    from repro_torch.kernels import ops
    before = (ops.recommend_topk_peruser, ops.dmf_fused_step, dmf.scatter_add_rows_,
              dmf._sparse_batch_update)
    for kind, names in faults.FAULTS.items():
        for fault in names:
            with faults.planted(kind, fault):
                pass
    assert before == (ops.recommend_topk_peruser, ops.dmf_fused_step, dmf.scatter_add_rows_,
                      dmf._sparse_batch_update)


@pytest.mark.parametrize("cell", sorted(_tiny.KIND))
def test_control_is_not_correct_and_sound_runs_are(cell):
    rows = list(control.readings(cell, [5], [5, 6, 7], [], 0.3, "cpu", _tiny.CONFIG,
                                 _tiny.TRAFFIC[_tiny.KIND[cell]], MAN))
    limits = MAN.limits(cell)
    for what, _, r in rows:
        ok, _ = compare.verdict(r, limits)
        assert ok is (what == "sound"), (what, r)
