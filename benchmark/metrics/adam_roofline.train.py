"""Adam's share of its roofline: the least time of its bytes (every
parameter, gradient and both moments read, parameter and moments written,
float32) over the device time between events around
``fused_adam_update``."""


def read(trace):
    layer = trace["layers"].get("adam")
    if not layer or layer["ms"] <= 0 or layer["bound_ms"] <= 0:
        return None
    return 100.0 * layer["bound_ms"] / layer["ms"]
