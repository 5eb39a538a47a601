"""Host milliseconds a round in `ServingEngine.ingest` (the walk table's
receivers read back, each step's negatives, padding and uploads, the
update calls' launches and loss reads, the seen bits, cold and popularity
upkeep): the traced wall time of the ingest calls less the device-busy
time inside them, over the traced rounds."""


def read(ctx, peaks):
    ingests = ctx.get("ingests")
    if not ingests or len(ingests) != len(ctx["rounds"]):
        return None
    tr = ctx["trace"]
    return sum((e - s) - tr.busy(s, e) for s, e in ingests) / 1e3 / len(ingests)
