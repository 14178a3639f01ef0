"""The host ms of an epoch's CUDA-graph captures (the trainer's
capture_ms), averaged over the window's epochs; None off the chunked
route."""


def read(ctx):
    recs = [r for r in ctx.get("records", [])
            if r.get("dispatch") == "chunked"]
    if not recs:
        return None
    return float(sum(r["capture_ms"] for r in recs) / len(recs))
