"""Host nanoseconds a hit of the service's hit lists over the traced
slice: the program's ``service.hits`` spans (its pass over the device's
window, ``service.py::PPRService._hits_from_ids``) over its counter
``service.hits_built``, the hits those passes built
(``benchmark/spans.py``): the hit lists' speed apart from how many hits
the windows hold. A program without the counter reads None."""

from benchmark import spans

#: the program's span around one pass over a window
SPAN = "service.hits"


def read(ctx):
    built = spans.counter("service.hits_built")
    if not built or not built[0]:
        return None
    ns = sum(s.end_ns - s.start_ns for s in spans.spans() if s.name == SPAN)
    return ns / built[0] if ns > 0 else None
