"""The hash encode's backward share of its roofline: the least time of
the bytes it has to move (the distinct table rows the step's samples
touch, the positions, the blend codes and the features, float32) over the
device time of every call bracketed around
the encode's and the quad fold's backward (kernels A3-bwd and B4), with whatever they launch."""


def read(trace):
    layer = trace["layers"].get("encode_bwd")
    if not layer or layer["ms"] <= 0 or layer["bound_ms"] <= 0:
        return None
    return 100.0 * layer["bound_ms"] / layer["ms"]
