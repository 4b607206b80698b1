"""The hash encode's forward share of its roofline: the least time of
the bytes it has to move (the distinct table rows the step's samples
touch, the positions, the blend codes and the features, float32) over the
device time of every call bracketed around
the quad build and the encode (kernels B3 and A3-fwd), with whatever they launch."""


def read(trace):
    layer = trace["layers"].get("encode_fwd")
    if not layer or layer["ms"] <= 0 or layer["bound_ms"] <= 0:
        return None
    return 100.0 * layer["bound_ms"] / layer["ms"]
