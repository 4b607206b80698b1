"""SE(3) deformation field (port of nersemble_tpu/models/deformation.py).

Windowed positional encoding of AABB-normalized positions + a per-timestep
warp code feed a skip-connection MLP stem (kernel B1-fwd on CUDA); one
128-column linear head (columns 0:3 = v, 3:6 = r, the rest padding, kept
for checkpoint layout) gives the screw axis whose exponential warps the
point. Offsets are in normalized units, NaN-guarded to zero in the forward
and the backward. On the card the input encoding and the guarded exponential
map are hand kernels (``ops/se3_warp.py``); on the CPU the plain chain.
"""

import torch

from nersemble_tpu_torch.config import SE3DeformationFieldConfig
from nersemble_tpu_torch.ops.fused_mlp import mlp_apply
from nersemble_tpu_torch.ops.mlp import apply_linear, init_linear, init_mlp
from nersemble_tpu_torch.ops.posenc import posenc_out_dim
from nersemble_tpu_torch.ops.se3_warp import se3_offsets, warp_input

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
    ``use_fused_mlp=False``, the unfused ``apply_mlp``. On the card the
    positions may not require a gradient (``ops/se3_warp.py``)."""
    stem_in = warp_input(positions_normalized, warp_code, config.n_freq_pos, window_param)
    skips = tuple(config.skip_connections)
    feat = mlp_apply(use_fused_mlp)(params.stem, stem_in, "relu", compute_dtype, skips)
    return se3_offsets(apply_linear(params.head_rv, feat, compute_dtype),
                       positions_normalized)
