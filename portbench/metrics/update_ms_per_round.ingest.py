"""Host milliseconds a round in the online refresh's ``online.update``
spans (a batch's gathers, kernel 3, the three scatters' launches and the
loss read back): their traced wall time less the device-busy time inside
them, over the traced rounds. None without the program's spans, one an
update batch."""
from portbench.metrics._ingest_round import host_ms_per_round


def read(ctx, peaks):
    if not ctx.get("batches"):
        return None
    return host_ms_per_round(ctx, "online.update", sum(len(b) for b in ctx["batches"]))
