"""The trace reader on a hand-made Chrome trace: the busy union, kernels
by name, spans, and the breakdown's idle gaps by host activity."""
import pytest

from portbench.devtrace import Trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


@pytest.fixture
def tr():
    return Trace({"traceEvents": [
        ev("portbench.pass", "user_annotation", 0, 50),
        ev("topk_rows_kernel<8, 10, true>", "kernel", 0, 10),
        ev("void at::native::indexing_backward_kernel<float>", "kernel", 5, 15),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 30, 10),
        ev("portbench.pass", "gpu_user_annotation", 0, 50),
        ev("aten::x", "cpu_op", 20, 15),
        ev("cudaStreamSynchronize", "cuda_runtime", 40, 10),
        {"ph": "i", "name": "instant", "ts": 3},
    ]})


def test_busy_union(tr):
    assert tr.busy(0, 50) == 30.0          # [0, 20] and [30, 40]
    assert tr.busy(10, 35) == 15.0
    assert tr.busy(20, 30) == 0.0


def test_kernels_and_spans(tr):
    assert len(tr.kernels(0, 50)) == 2     # a memcpy is no kernel
    assert [k[2] for k in tr.kernels(0, 50, r"\btopk_rows_kernel\b")] == [
        "topk_rows_kernel<8, 10, true>"]
    assert tr.spans("portbench.pass") == [(0.0, 50.0)]


def test_breakdown(tr):
    b = tr.breakdown(0, 50)
    assert b["device_ops"][0] == ["void at::native::indexing_backward_kernel<float>", 15e-6]
    assert dict(b["idle_gaps"]) == {"aten::x": 10e-6, "cudaStreamSynchronize": 10e-6}
