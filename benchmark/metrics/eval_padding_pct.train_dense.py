"""Rows the field evaluated that held no valid sample, as a share of the
rows it evaluated, over the traced steps after the window (the loop's
``spans_steps``): the port's counters ``samples_evaluated``
(rows, padding included) against ``samples_valid`` less
``samples_budget_dropped`` (the valid samples it kept)."""


def read(trace):
    counters = trace.get("counters") or {}
    rows = counters.get("samples_evaluated", 0.0)
    if rows <= 0 or "samples_valid" not in counters:
        return None
    kept = counters["samples_valid"] - counters.get("samples_budget_dropped", 0.0)
    return 100.0 * (rows - kept) / rows
