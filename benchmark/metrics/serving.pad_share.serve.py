"""The share of the rows the engine computed that were padding (the pow2
rungs of ``PPRBatchServer``) over the window: ``padded_rows`` over
``dispatched_rows + padded_rows``, deltas of ``ServerStats``."""


def read(ctx):
    c = ctx.record.counters
    rows = c.get("dispatched_rows", 0) + c.get("padded_rows", 0)
    if not rows:
        return None
    return 100.0 * c["padded_rows"] / rows
