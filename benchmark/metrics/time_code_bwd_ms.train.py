"""Device milliseconds per step of the time codes' backward: the
gradients of the per-timestep embeddings' row gathers, bracketed from the
gradient's arrival at the gathered codes to its departure to the
embedding."""


def read(trace):
    layer = trace["layers"].get("time_code_bwd")
    steps = trace.get("steps") or 0
    if not layer or layer["calls"] == 0 or not steps:
        return None
    return layer["ms"] / steps
