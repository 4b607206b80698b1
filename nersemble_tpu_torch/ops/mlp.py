"""MLP parameters and the plain mixed-precision apply (port of
nersemble_tpu/ops/mlp.py).

Weights are stored ``[in, out]`` like the JAX package (not ``nn.Linear``'s
``[out, in]``), so checkpoints interchange. ``apply_linear`` rounds both
operands to the compute dtype and multiplies in float32: the product of two
bf16 values is exact in float32, so this is JAX's bf16 x bf16 ->
``preferred_element_type=f32`` product up to summation order. (A bf16
``torch.matmul`` would round its output to bf16, which JAX does not.)
"""

import math
from typing import Optional, Sequence

import torch

from nersemble_tpu_torch.utils.params import uniform


def init_linear(generator: torch.Generator, in_dim: int, out_dim: int,
                bias: bool = True, weight_init_scale: Optional[float] = None):
    """One linear layer as ``{"w": [in, out], "b": [out]}``; init as
    torch.nn.Linear's default, or U(-s, s) weights and zero bias when
    ``weight_init_scale`` is given (near-identity heads)."""
    s = weight_init_scale if weight_init_scale is not None \
        else math.sqrt(1.0 / in_dim)
    layer = {"w": uniform((in_dim, out_dim), -s, s, generator)}
    if bias:
        layer["b"] = torch.zeros(out_dim, device=generator.device) \
            if weight_init_scale is not None \
            else uniform((out_dim,), -s, s, generator)
    return layer


def init_mlp(generator: torch.Generator, in_dim: int, out_dim: int,
             num_layers: int, layer_width: int,
             skip_connections: Sequence[int] = (), bias: bool = True):
    """``num_layers`` linear layers; layers in ``skip_connections`` take
    ``[hidden, input]`` concatenated."""
    skips = set(skip_connections)
    layers = []
    for i in range(num_layers):
        if num_layers == 1:
            d_in, d_out = in_dim, out_dim
        elif i == 0:
            d_in, d_out = in_dim, layer_width
        elif i in skips:
            d_in, d_out = layer_width + in_dim, layer_width
        elif i == num_layers - 1:
            d_in, d_out = layer_width, out_dim
        else:
            d_in, d_out = layer_width, layer_width
        layers.append(init_linear(generator, d_in, d_out, bias=bias))
    return {"layers": layers}


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (round to nearest even), kept float32."""
    return x.to(dtype).to(torch.float32)


def apply_linear(layer, x: torch.Tensor,
                 compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    out = round_to(x, compute_dtype) @ round_to(layer.w, compute_dtype)
    if "b" in layer:
        out = out + layer.b
    return out


def apply_mlp(params, x: torch.Tensor, out_activation: Optional[str] = None,
              compute_dtype: torch.dtype = torch.bfloat16,
              skip_connections: Sequence[int] = ()) -> torch.Tensor:
    """Forward through the MLP with relu hidden activations; float32 out.
    ``out_activation`` is None, "relu" or "sigmoid"."""
    layers = params.layers
    skips = set(skip_connections)
    x_in = x.to(torch.float32)
    h = x_in
    for i, layer in enumerate(layers):
        if i in skips and i > 0:
            h = torch.cat([h, x_in], dim=-1)
        h = apply_linear(layer, h, compute_dtype)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return activate(h, out_activation)


def activate(h: torch.Tensor, kind: Optional[str]) -> torch.Tensor:
    if kind == "sigmoid":
        return torch.sigmoid(h)
    if kind == "relu":
        return torch.relu(h)
    if kind in (None, "none"):
        return h
    raise ValueError(f"unknown activation {kind!r}")
