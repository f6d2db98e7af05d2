"""Rows a dispatch of the serving layer (``PPRBatchServer``) over the
window: deltas of ``ServerStats.dispatched_rows`` and ``dispatches``."""


def read(ctx):
    c = ctx.record.counters
    if not c.get("dispatches"):
        return None
    return c["dispatched_rows"] / c["dispatches"]
