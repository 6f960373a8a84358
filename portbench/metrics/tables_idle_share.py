"""The device's idle share while the port proves its tables: 1 minus the
device's busy time (kernels, copies and sets, ``Trace.busy``) inside the
port's ``tables`` spans over their length.  The host witness lies outside
them."""

from portbench.core.spans import busy_us_inside, intervals


def read(run):
    spans_us = intervals(run, "tables")
    length = sum(b - a for a, b in spans_us)
    if not length:
        return None
    return 1.0 - busy_us_inside(run.trace, spans_us) / length
