"""The share of a profiled segment of the loop in which no kernel, copy or
memset ran on the device."""


def read(trace):
    prof = trace.get("profile") or {}
    window, busy = prof.get("window_s", 0.0), prof.get("busy_s", 0.0)
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
