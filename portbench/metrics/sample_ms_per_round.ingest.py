"""Host milliseconds a round in the online refresh's ``online.sample``
spans (a step's negatives drawn, its batches padded and uploaded): their
traced wall time less the device-busy time inside them, over the traced
rounds. None without the program's spans, one a step of each round."""
from portbench.metrics._ingest_round import host_ms_per_round


def read(ctx, peaks):
    if "steps" not in ctx:
        return None
    return host_ms_per_round(ctx, "online.sample", ctx["steps"] * len(ctx["rounds"]))
