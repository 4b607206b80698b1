"""Peaks of the card and the least work of each layer, for roofline shares.

Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM, 989 TFLOP/s in bf16 on the tensor cores, 67
TFLOP/s in float32 outside them. A bound counts each input byte read once
and each output byte written once; where the work depends on the data it
counts what these inputs need (the table rows the samples touch), not the
most they could.
"""

from typing import Dict, List, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
F32 = 4


def bound_ms(n_bytes: float = 0.0, bf16_flops: float = 0.0,
             f32_flops: float = 0.0) -> float:
    """The least time in ms: the larger of bytes over the memory rate and
    operations over their peak rate."""
    return 1e3 * max(n_bytes / PEAK_BYTES_PER_S,
                     bf16_flops / PEAK_BF16_FLOPS + f32_flops / PEAK_F32_FLOPS)


def adam_bound_ms(n_elements: int) -> float:
    """Adam over ``n_elements`` float32 parameters: read the parameter, its
    gradient and both moments, write the parameter and both moments; about
    ten float32 operations an element."""
    return bound_ms(n_bytes=7 * F32 * n_elements, f32_flops=10.0 * n_elements)


def encode_bytes(n_samples: int, rows: float, lv: Dict, code_cols: int) -> float:
    """The encode of ``n_samples`` positions: the ``rows`` distinct table
    rows they touch (float32, ``lv["width"]`` wide), the positions, the
    blend codes and the [n, L*F] float32 features. Its backward moves the
    same bytes the other way (the features' gradient in, the touched rows'
    gradient, the codes' and the positions' gradient out)."""
    feats = lv["n_levels"] * lv["features"]
    return F32 * (rows * lv["width"] + n_samples * (3 + code_cols + feats))


def encode_bound_ms(n_samples: int, rows: float, lv: Dict, code_cols: int) -> float:
    """Bytes-bound: the interpolation's operations (about 8 corners x 3
    weights x the row width per level and sample, in float32) stay far
    below the bytes' time."""
    flops = 2.0 * n_samples * lv["n_levels"] * 8 * lv["width"]
    return bound_ms(n_bytes=encode_bytes(n_samples, rows, lv, code_cols),
                    f32_flops=flops)


def mlp_macs(shapes: List[Tuple[int, int]]) -> int:
    """Multiply-adds of one row through layers of [in, out] weights."""
    return sum(a * b for a, b in shapes)


def mlp_bwd_bound_ms(n_rows: int, shapes: List[Tuple[int, int]]) -> float:
    """The backward of an MLP over ``n_rows`` rows: the input and weight
    gradients (2 products of 2 n in out operations per layer, bf16 tensor
    cores), reading the float32 input and output gradient and writing the
    float32 input gradient."""
    flops = 4.0 * n_rows * mlp_macs(shapes)
    n_bytes = F32 * n_rows * (2 * shapes[0][0] + shapes[-1][1])
    return bound_ms(n_bytes=n_bytes, bf16_flops=flops)


def model_flops_per_sample(m: Dict) -> float:
    """Forward and backward operations of the three MLPs for one evaluated
    sample at the configuration's widths: 2 per multiply-add forward, 4
    backward. The SE(3) stem counts its 6-wide screw head; the density MLP
    takes the L*F features and gives 1 + geo features; the colour MLP
    takes the direction and the geo features."""
    def chain(d_in, d_out, n, width, skips=()):
        shapes = []
        for i in range(n):
            a = d_in if i == 0 else width + (d_in if i in skips else 0)
            b = d_out if i == n - 1 else width
            shapes.append((a, b))
        return shapes

    if m["use_hash_ensemble"]:
        hc = m["hash_ensemble"]["hash_encoding"]
        feats = hc["n_levels"] * hc["n_features_per_level"]
    else:
        feats = m["num_levels"] * 2
    shapes = chain(feats, 1 + m["geo_feat_dim"], m["num_layers"], m["hidden_dim"])
    shapes += chain(3 + m["geo_feat_dim"], 3, m["num_layers_color"], m["hidden_dim_color"])
    if m["use_deformation_field"]:
        d = m["deformation_field"]
        d_in = 2 * 3 * d["n_freq_pos"] + 3 + d["warp_code_dim"]
        w = d["mlp_layer_width"]
        shapes += chain(d_in, w, d["mlp_num_layers"], w, tuple(d["skip_connections"]))
        shapes.append((w, 6))
    return 6.0 * mlp_macs(shapes)
