"""``enqueue_ms.latency``: the median host ms from the call of ``R3MEncoder`` until it
returns, before the client waits for the embedding (the harness's own span)."""

import statistics


def read(ctx):
    spans = ctx.spans.get("enqueue")
    return 1e3 * statistics.median(spans) if spans else None
