"""Mean ms a request of the traced slice waited in ``PPRBatchServer``'s
queue, from its submit to the start of the dispatch that carried it: the
program's counter ``serving.queue_wait`` (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    c = spans.counter("serving.queue_wait")
    return c[0] / c[1] if c else None
