"""The device's idle share of the traced window: the share of its length
in which no kernel, copy or set ran on the card."""


def read(run):
    if run.trace is None or not run.trace.ops or run.trace.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s() / run.trace.window_s
