"""The MLPs' backward share of its roofline (kernel B2 and whatever its
call launches): the larger of its bf16 tensor-core operations and its
float32 input, output-gradient and input-gradient bytes, over the device
time bracketed around each fused MLP's backward."""


def read(trace):
    layer = trace["layers"].get("mlp_bwd")
    if not layer or layer["ms"] <= 0 or layer["bound_ms"] <= 0:
        return None
    return 100.0 * layer["bound_ms"] / layer["ms"]
