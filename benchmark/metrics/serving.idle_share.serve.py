"""The share of the traced slice's wall in which no kernel ran while the
dispatcher was in a ``serving.*`` span (forming a batch, waiting for
requests, resolving futures) and outside ``service.top_k``
(``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.idle_share(ctx, "serving")
