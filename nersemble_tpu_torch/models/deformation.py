"""SE(3) deformation field (port of nersemble_tpu/models/deformation.py).

Windowed positional encoding of AABB-normalized positions + a per-timestep
warp code feed a skip-connection MLP stem (kernel B1-fwd on CUDA); one
128-column linear head (columns 0:3 = v, 3:6 = r, the rest padding, kept
for checkpoint layout) gives the screw axis whose exponential warps the
point. Offsets are in normalized units, NaN-guarded to zero in the forward
and the backward.
"""

import torch

from nersemble_tpu_torch.config import SE3DeformationFieldConfig
from nersemble_tpu_torch.ops.fused_mlp import mlp_apply
from nersemble_tpu_torch.ops.mlp import apply_linear, init_linear, init_mlp
from nersemble_tpu_torch.ops.posenc import posenc_out_dim, windowed_posenc
from nersemble_tpu_torch.utils.se3 import se3_apply

HEAD_PAD = 128  # head_rv columns (checkpoint layout of the JAX package)


def init_deformation_field(generator: torch.Generator,
                           config: SE3DeformationFieldConfig):
    in_dim = posenc_out_dim(3, config.n_freq_pos) + config.warp_code_dim
    return {
        "stem": init_mlp(generator, in_dim, config.mlp_layer_width,
                         config.mlp_num_layers, config.mlp_layer_width,
                         skip_connections=tuple(config.skip_connections)),
        "head_rv": init_linear(generator, config.mlp_layer_width, HEAD_PAD,
                               weight_init_scale=1e-5),
    }


def deformation_offsets(params, positions_normalized: torch.Tensor,
                        warp_code: torch.Tensor,
                        config: SE3DeformationFieldConfig,
                        window_param=None,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        use_fused_mlp: bool = True) -> torch.Tensor:
    """[N, 3] AABB-normalized positions + [N, D] warp codes -> [N, 3]
    offsets in normalized units; the stem through the fused MLP or, with
    ``use_fused_mlp=False``, the unfused ``apply_mlp``."""
    enc = windowed_posenc(positions_normalized, config.n_freq_pos,
                          min_freq_exp=0.0, max_freq_exp=config.n_freq_pos - 1,
                          include_input=True, window_param=window_param)
    stem_in = torch.cat([enc, warp_code.to(enc.dtype)], dim=-1)
    skips = tuple(config.skip_connections)
    feat = mlp_apply(use_fused_mlp)(params.stem, stem_in, "relu", compute_dtype, skips)
    screw = apply_linear(params.head_rv, feat, compute_dtype)[:, :6]
    pos32 = positions_normalized.to(torch.float32)
    screw = screw.to(torch.float32)
    # the NaN guard (JAX: where(isnan(warped), pos32, warped)) with its
    # backward kept finite: rows whose warp is NaN somewhere take the JAX
    # values without a gradient, and se3_apply differentiates a zero screw
    # there instead of the one that gave NaN (the double-where pattern)
    with torch.no_grad():
        raw = se3_apply(screw, pos32)
    bad = torch.isnan(raw)
    row_bad = bad.any(dim=-1, keepdim=True)
    safe = se3_apply(torch.where(row_bad, torch.zeros_like(screw), screw), pos32)
    warped = torch.where(row_bad, torch.where(bad, pos32, raw), safe)
    return warped - pos32
