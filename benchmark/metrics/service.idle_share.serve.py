"""The share of the traced slice's wall in which no kernel ran while the
host was in ``service.top_k`` and outside its ``loop.topk`` spans: the hit
lists and the dense recompute (``benchmark/spans.py``; the served cells)."""

from benchmark import spans


def read(ctx):
    return spans.idle_share(ctx, "service")
