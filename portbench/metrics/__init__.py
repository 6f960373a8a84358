"""One reader per metric, found by the metric's name in ``BENCHMARK.json``.

Each module ``<name>.py`` defines ``read(run) -> float | None`` over a
``core.harness.Run``: the window's iterations, its length, the set-up time,
the peak device memory and, in a traced run, the ``core.trace.Trace``.  A
reader that finds nothing to read returns None, and the run leaves that
metric out of its line."""
