"""Density + colour field with the hash ensemble (port of
nersemble_tpu/models/field.py).

Base: blended hash-ensemble encoding -> 64-wide bias-free MLP ->
[density logit, 15 geo features]; density = exp in float32, zeroed outside
the open unit cube (strict selector). Colour head: [shifted view direction,
geo features] -> 64-wide bias-free MLP -> sigmoid. Both MLPs run through
kernel B1-fwd on CUDA.
"""

from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from nersemble_tpu_torch.config import ModelConfig
from nersemble_tpu_torch.ops.fused_mlp import fused_mlp_apply
from nersemble_tpu_torch.ops.hash_encoding import (
    HashGridLevels,
    build_quad_table,
    hash_encode_blended,
)
from nersemble_tpu_torch.ops.hash_ensemble import effective_blend_code
from nersemble_tpu_torch.ops.mlp import init_mlp
from nersemble_tpu_torch.ops.sh import shift_directions
from nersemble_tpu_torch.ops.trunc_exp import trunc_exp
from nersemble_tpu_torch.utils.params import uniform


def _require_supported(config: ModelConfig) -> None:
    if not config.use_hash_ensemble:
        raise NotImplementedError("the single-grid field is not ported yet")
    if config.spherical_harmonics_degree > 0:
        raise NotImplementedError("SH direction encoding is not ported yet")
    if config.use_appearance_embedding:
        raise NotImplementedError("the appearance embedding is not ported yet")
    if not config.use_fused_mlp:
        # fused_mlp_apply is the one MLP path: on CPU tensors its plain
        # version computes exactly what apply_mlp (the JAX package's unfused
        # path) does, and on CUDA the MLPs run through kernel B1-fwd
        raise NotImplementedError("use_fused_mlp=False has no separate path")


def build_levels(config: ModelConfig) -> HashGridLevels:
    _require_supported(config)
    hc = config.hash_ensemble.hash_encoding
    return HashGridLevels.create(hc.n_levels, hc.log2_hashmap_size,
                                 hc.base_resolution, hc.per_level_scale)


def table_row_width(config: ModelConfig) -> Tuple[int, int]:
    """(row width W, features per logical table F_l) of the [E, W] table:
    row e packs every logical table's features at entry e."""
    he = config.hash_ensemble
    f_l = he.hash_encoding.n_features_per_level
    return he.n_hash_encodings * f_l, f_l


def init_field(generator: torch.Generator, config: ModelConfig,
               levels: HashGridLevels) -> Dict:
    _require_supported(config)
    row_width, f_l = table_row_width(config)
    params = {
        "table": uniform((levels.total_entries, row_width), -1e-4, 1e-4,
                         generator),
        "mlp_base": init_mlp(generator, levels.n_levels * f_l,
                             1 + config.geo_feat_dim, config.num_layers,
                             config.hidden_dim, bias=False),
    }
    params["mlp_head"] = init_mlp(generator, 3 + config.geo_feat_dim, 3,
                                  config.num_layers_color,
                                  config.hidden_dim_color, bias=False)
    return params


def normalize_positions(positions, aabb_min, aabb_max):
    return (positions - aabb_min) / (aabb_max - aabb_min)


def prepare_field(field_params, config: ModelConfig,
                  levels: HashGridLevels) -> Dict:
    """Per-params table preparation, hoisted out of the sample-chunk loop:
    the xz-quad gather operand [E, 4W] in the table dtype (kernel B3 on
    CUDA) next to the MLP parameters."""
    quad = build_quad_table(field_params.table, levels,
                            getattr(torch, config.table_dtype))
    return {"table_quad": quad, "mlp_base": field_params.mlp_base,
            "mlp_head": field_params.mlp_head}


def field_density(fparams: Dict, positions_world: torch.Tensor,
                  time_codes: torch.Tensor, config: ModelConfig,
                  levels: HashGridLevels, aabb_min, aabb_max,
                  window_hash: Optional[float] = None,
                  compute_dtype: torch.dtype = torch.bfloat16):
    """[N, 3] world positions -> (density [N] f32, geo features [N, G])."""
    norm = normalize_positions(positions_world, aabb_min, aabb_max)
    selector = ((norm > 0.0) & (norm < 1.0)).all(dim=-1)
    norm = norm * selector[..., None]
    he = config.hash_ensemble
    smoothstep = he.hash_encoding.interpolation == "Smoothstep"
    code = effective_blend_code(time_codes, window_hash, he.n_hash_encodings,
                                he.disable_initial_hash_ensemble,
                                he.use_soft_transition)
    with record_function("field:hash_encode"):
        base_in = hash_encode_blended(
            fparams["table_quad"], norm, code, levels,
            features_per_logical=table_row_width(config)[1],
            smoothstep=smoothstep)
    h = fused_mlp_apply(fparams["mlp_base"], base_in, None, compute_dtype)
    density = trunc_exp(h[..., 0]) * selector
    return density, h[..., 1:]


def field_rgb(fparams: Dict, directions: torch.Tensor, geo: torch.Tensor,
              config: ModelConfig,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[N, 3] unit view directions + [N, G] geo features -> [N, 3] rgb."""
    h = torch.cat([shift_directions(directions).to(torch.float32),
                   geo.to(torch.float32)], dim=-1)
    return fused_mlp_apply(fparams["mlp_head"], h, "sigmoid", compute_dtype)
