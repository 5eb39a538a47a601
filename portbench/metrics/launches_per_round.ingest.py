"""Device kernels a round in `ServingEngine.ingest`: the kernels that start
inside the traced ingest calls (each ends with the card's queue drained),
over the traced rounds."""


def read(ctx, peaks):
    ingests = ctx.get("ingests")
    if not ingests or len(ingests) != len(ctx["rounds"]):
        return None
    tr = ctx["trace"]
    return sum(len(tr.kernels(s, e)) for s, e in ingests) / len(ingests)
