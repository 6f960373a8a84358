"""The benchmark's general machinery: the specification it reads, the
traffic generator, the measured window, the trace reader and the roofline
arithmetic.  Nothing here is particular to one configuration, one mix or
one per-layer metric."""
