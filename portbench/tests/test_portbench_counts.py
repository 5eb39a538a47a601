"""The yardstick's counts against shapes worked by hand."""
import numpy as np
import pytest

from portbench.counts import dmf_step, least_seconds, peaks_for, topk_rows, train_epoch

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("seen,want_bytes,want_ops", [
    # 2,048 users over 7,404 POIs, K=10, k=10: per user 40 B of U, 7,404 B
    # of seen row, 8 B of row id, 80 B of slate; 80 B of P and Q a live POI
    (0, 2048 * (40 + 7404 + 8 + 80) + 2048 * 7404 * 80, 2048 * 7404 * 30),
    (100, 2048 * (40 + 7404 + 8 + 80) + (2048 * 7404 - 100) * 80, (2048 * 7404 - 100) * 30),
])
def test_topk_rows(seen, want_bytes, want_ops):
    assert topk_rows.count(2048, 7404, 10, 10, seen) == (want_bytes, want_ops)
    assert want_bytes == 1_228_496_896 - 8000 * (seen // 100)


def test_dmf_step():
    # u, p, q (40 B each) + r, conf (8 B) in; du, gp, dq (120 B) out; a loss
    assert dmf_step.count(2048, 10) == (2048 * 128 + 2048 * 120 + 4, 2048 * 125)
    assert dmf_step.count(2048, 10)[0] == 507_908


def test_train_epoch():
    # 3 events from senders 0, 1, 1 with 3 and 2 receivers: 7 slots
    nbytes, ops = train_epoch.count(np.array([0, 1, 1]), np.array([3, 2]), 10)
    assert nbytes == 3 * 24 + 3 * 120 + 3 * 80 + 7 * (12 + 80) == 1316
    assert ops == 3 * 125 + 7 * 20 == 515


def test_peaks_and_least_time():
    peaks = peaks_for(H100)
    assert peaks["hbm_bytes_per_s"] == 3.35e12 and peaks["fp32_flops_per_s"] == 67e12
    assert least_seconds(3.35e12, 0.0, peaks) == 1.0
    assert least_seconds(0.0, 67e12, peaks) == 1.0
    assert least_seconds(3.35e12, 134e12, peaks) == 2.0
    assert peaks_for("cpu") is None
