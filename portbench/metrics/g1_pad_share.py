"""The Witness layer's g1mul tables: the share of their rows that are
padding, 1 − the port's ``g1_chain_rows`` counter (the rows the chains
fill, Σ bits·7 + 2 a chain) over its ``g1_trace_rows`` counter (the
tables' heights), both counted by ``stark/g1mul_air.py:generate_trace``
once a table is assembled and summed over the window's ``prove`` roots.
None when either counter is absent (a port without them)."""

from portbench.core.spans import by_root, window_records


def read(run):
    groups = by_root(window_records(run), "prove")
    totals = {}
    for name in ("g1_chain_rows", "g1_trace_rows"):
        found = [r.counters[name] for g in groups for r in g if name in r.counters]
        if not found:
            return None
        totals[name] = sum(found)
    return 1.0 - totals["g1_chain_rows"] / totals["g1_trace_rows"]
