"""The readers of the program's dispatch spans and counts on hand-made
traces and event lists: the five phases' host milliseconds a dispatch and
kernel 2's useful-row share, each against its value by hand, and None
where a phase span is missing or the counts disagree."""
import pytest

from portbench.devtrace import Trace
from portbench.manifest import Manifest

MAN = Manifest()
PHASES = ("prepare", "upload", "launch", "readback", "finish")
# one dispatch, times in µs from its start: (start, end) of each phase
LAYOUT = {"prepare": (5, 15), "upload": (15, 20), "launch": (20, 40), "readback": (40, 80),
          "finish": (80, 95)}
DEVICE = [("kernel", 30, 30), ("gpu_memcpy", 70, 5)]     # the kernel, a copy back
# host µs of each phase in a dispatch: its wall less the busy union inside
HOST_US = {"prepare": 10, "upload": 5, "launch": 10, "readback": 15, "finish": 15}
STARTS = (0, 200)                                            # two dispatches, 100 µs each


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": float(ts), "dur": float(dur)}


def trace_doc(drop=(), moved=()):
    """Two dispatches; ``drop`` leaves out (dispatch, phase) spans,
    ``moved`` puts (dispatch, phase) spans into the other dispatch."""
    evs = []
    for d, t0 in enumerate(STARTS):
        evs.append(ev("portbench.dispatch", "user_annotation", t0, 100))
        evs.append(ev("engine.serve_microbatch", "user_annotation", t0 + 2, 96))
        for phase, (a, b) in LAYOUT.items():
            if (d, phase) in drop:
                continue
            shift = STARTS[1 - d] - t0 if (d, phase) in moved else 0
            evs.append(ev(f"engine.{phase}", "user_annotation", t0 + a + shift, b - a))
        for cat, a, dur in DEVICE:
            evs.append(ev("topk_rows_kernel" if cat == "kernel" else "Memcpy DtoH", cat,
                          t0 + a, dur))
    return {"traceEvents": evs}


def ctx_of(doc):
    tr = Trace(doc)
    disp = [(s, e, 2048, 0) for s, e in tr.spans("portbench.dispatch")]
    return {"trace": tr, "dispatches": disp}


@pytest.mark.parametrize("phase", PHASES)
def test_phase_reads_its_host_time_by_hand(phase):
    got = MAN.reader(f"{phase}_ms_per_dispatch.refresh").read(ctx_of(trace_doc()), None)
    assert got == pytest.approx(HOST_US[phase] / 1e3)


def test_phases_add_up_to_the_dispatch_less_what_no_phase_covers():
    ctx = ctx_of(trace_doc())
    phases = sum(MAN.reader(f"{p}_ms_per_dispatch.refresh").read(ctx, None) for p in PHASES)
    whole = MAN.reader("host_ms_per_dispatch.refresh").read(ctx, None)
    # the dispatch's 100 µs less 35 busy; the phases leave out 0-5 and 95-100
    assert whole == pytest.approx(0.065) and phases == pytest.approx(0.055)


@pytest.mark.parametrize("phase", PHASES)
def test_phase_missing_from_a_dispatch_reads_none(phase):
    ctx = ctx_of(trace_doc(drop={(1, phase)}))
    assert MAN.reader(f"{phase}_ms_per_dispatch.refresh").read(ctx, None) is None
    others = [p for p in PHASES if p != phase]
    assert all(MAN.reader(f"{p}_ms_per_dispatch.refresh").read(ctx, None) is not None
               for p in others)


@pytest.mark.parametrize("phase", PHASES)
def test_phase_spans_not_one_a_dispatch_read_none(phase):
    """As many spans as dispatches, but two in the first and none in the
    second."""
    ctx = ctx_of(trace_doc(moved={(1, phase)}))
    assert len(ctx["trace"].spans(f"engine.{phase}")) == len(ctx["dispatches"])
    assert MAN.reader(f"{phase}_ms_per_dispatch.refresh").read(ctx, None) is None


def test_phase_readers_without_dispatches_read_none():
    for p in PHASES:
        assert MAN.reader(f"{p}_ms_per_dispatch.refresh").read({}, None) is None


def serve_events(counts):
    """``engine.serve_microbatch`` events of (rows, n_real, n_fallback),
    among the phase spans' events, which the share skips."""
    evs = []
    for d, (rows, n, nf) in enumerate(counts):
        evs.append({"name": "engine.prepare", "ph": "X", "args": {"dispatch": d}})
        evs.append({"name": "engine.serve_microbatch", "ph": "X",
                    "args": {"depth": 0, "dispatch": d, "rows": rows, "n_real": n,
                             "n_fallback": nf}})
    return evs


SHARE = MAN.reader("useful_row_share.refresh")
COUNTS = [(2048, 2048, 190), (2048, 2048, 210), (2048, 380, 31)]


def test_useful_row_share_by_hand():
    # (2048 - 190 + 2048 - 210 + 380 - 31) / (3 x 2048)
    assert SHARE.share(serve_events(COUNTS), 3) == pytest.approx(100 * 4045 / 6144)


def test_useful_row_share_none_when_the_counts_disagree():
    assert SHARE.share(serve_events(COUNTS), 4) is None
    assert SHARE.share(serve_events(COUNTS[:2]), 3) is None
    assert SHARE.share([], 0) is None
    bare = serve_events(COUNTS)
    del bare[-1]["args"]["n_fallback"]          # an event without its counts
    assert SHARE.share(bare, 3) is None


def test_useful_row_share_reads_the_programs_global_tracer():
    from repro_torch.obs import trace as trace_lib
    saved = trace_lib.get_tracer()
    try:
        trace_lib.set_tracer(trace_lib.Tracer(enabled=True))
        for d, (rows, n, nf) in enumerate(COUNTS):
            with trace_lib.span("engine.serve_microbatch", dispatch=d, rows=rows) as sp:
                sp.args.update(n_real=n, n_fallback=nf)
        ctx = {"dispatches": [(0.0, 1.0, n, 0) for _, n, _ in COUNTS]}
        assert SHARE.read(ctx, None) == pytest.approx(100 * 4045 / 6144)
        ctx["dispatches"].append((2.0, 3.0, 5, 0))
        assert SHARE.read(ctx, None) is None
        assert SHARE.read({}, None) is None
    finally:
        trace_lib.set_tracer(saved)
