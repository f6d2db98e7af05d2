"""The share of the traced slice's wall in which no kernel ran on the card
(the batch cells)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.idle_share is None:
        return None
    return 100.0 * ctx.trace.idle_share
