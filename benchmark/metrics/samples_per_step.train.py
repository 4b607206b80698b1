"""Samples the field evaluated per step: the march's valid samples less
those the compaction budget dropped, from the step's own counts, the mean
over the window's steps."""


def read(trace):
    steps = trace.get("steps") or 0
    return trace["evaluated_samples"] / steps if steps else None
