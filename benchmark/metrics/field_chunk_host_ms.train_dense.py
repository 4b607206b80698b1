"""Host milliseconds a field chunk took to launch: the mean over the
``render:chunk`` spans of the port's tracer (one per piece of at most
``max_n_samples_per_batch`` samples that the field evaluates) in the
traced steps after the window (the loop's ``spans_steps``), where no
layer timer runs."""


def read(trace):
    chunks = [s for s in trace.get("spans") or [] if s.get("name") == "render:chunk"]
    if not chunks:
        return None
    return sum(s["host_end_ns"] - s["host_start_ns"] for s in chunks) / len(chunks) / 1e6
