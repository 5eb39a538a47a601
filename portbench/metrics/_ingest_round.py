"""Shared by the readers of the online round (`foursquare.ingest_refresh`):
the program's spans inside the traced ingests, read a round."""


def host_ms_per_round(ctx, name: str, n_spans: int):
    """The program's ``name`` spans' traced wall time less the device-busy
    time inside them, in milliseconds a traced round. None unless there
    are ``n_spans`` of them, each inside one of the traced ingests."""
    ingests = ctx.get("ingests")
    if not ingests or len(ingests) != len(ctx["rounds"]):
        return None
    tr = ctx["trace"]
    spans = tr.spans(name)
    if not spans or len(spans) != n_spans:
        return None
    if not all(any(s <= a <= b <= e for s, e in ingests) for a, b in spans):
        return None
    return sum((b - a) - tr.busy(a, b) for a, b in spans) / 1e3 / len(ingests)
