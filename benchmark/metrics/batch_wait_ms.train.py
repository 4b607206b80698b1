"""Host milliseconds a step of the window spent in ``next(DeviceBatches)``
(the data pipeline's batch wait and its copy's issue), the mean over the
window's steps."""


def read(trace):
    waits = trace.get("batch_wait_s") or []
    return 1e3 * sum(waits) / len(waits) if waits else None
