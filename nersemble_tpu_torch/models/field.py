"""Density + colour field (port of nersemble_tpu/models/field.py).

Base: the blended hash-ensemble encoding, or the plain single-grid encoding
(``use_hash_ensemble=False``) -> 64-wide bias-free MLP -> [density logit,
15 geo features]; density = exp in float32, zeroed outside the open unit
cube (strict selector). Colour head: [direction encoding (shifted view
direction, or its SH basis of degree 1-4), geo features, optional per-image
appearance embedding (zeros at eval)] -> 64-wide bias-free MLP -> sigmoid.
Both MLPs run through kernel B1-fwd on CUDA, or, with
``use_fused_mlp=False``, as the JAX package's unfused chain.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nersemble_tpu_torch.config import ModelConfig
from nersemble_tpu_torch.ops.fused_mlp import mlp_apply
from nersemble_tpu_torch.ops.hash_encoding import (
    HashGridLevels,
    build_quad_table,
    hash_encode,
    hash_encode_blended,
)
from nersemble_tpu_torch.ops.hash_ensemble import effective_blend_code
from nersemble_tpu_torch.ops.mlp import init_mlp
from nersemble_tpu_torch.ops.sh import sh_encoding, sh_out_dim, shift_directions
from nersemble_tpu_torch.ops.trunc_exp import trunc_exp
from nersemble_tpu_torch.utils.params import normal, uniform


def build_levels(config: ModelConfig) -> HashGridLevels:
    if config.use_hash_ensemble:
        hc = config.hash_ensemble.hash_encoding
        return HashGridLevels.create(hc.n_levels, hc.log2_hashmap_size,
                                     hc.base_resolution, hc.per_level_scale)
    # single grid: growth from base and max resolution, as nerfstudio
    growth = float(np.exp((np.log(config.max_res)
                           - np.log(config.base_resolution))
                          / (config.num_levels - 1)))
    return HashGridLevels.create(config.num_levels, config.log2_hashmap_size,
                                 config.base_resolution, growth)


def table_row_width(config: ModelConfig) -> Tuple[int, int]:
    """(row width W, features per logical table F_l) of the [E, W] table:
    row e packs every logical table's features at entry e; the single grid
    is one table of 2 features."""
    if not config.use_hash_ensemble:
        return 2, 2
    he = config.hash_ensemble
    f_l = he.hash_encoding.n_features_per_level
    return he.n_hash_encodings * f_l, f_l


def direction_encoding_dim(config: ModelConfig) -> int:
    degree = config.spherical_harmonics_degree
    return sh_out_dim(degree) if degree > 0 else 3


def init_field(generator: torch.Generator, config: ModelConfig,
               levels: HashGridLevels) -> Dict:
    row_width, f_l = table_row_width(config)
    params = {
        "table": uniform((levels.total_entries, row_width), -1e-4, 1e-4,
                         generator),
        "mlp_base": init_mlp(generator, levels.n_levels * f_l,
                             1 + config.geo_feat_dim, config.num_layers,
                             config.hidden_dim, bias=False),
    }
    head_in = direction_encoding_dim(config) + config.geo_feat_dim
    if config.use_appearance_embedding:
        head_in += config.appearance_embedding_dim
    params["mlp_head"] = init_mlp(generator, head_in, 3,
                                  config.num_layers_color,
                                  config.hidden_dim_color, bias=False)
    if config.use_appearance_embedding:
        params["appearance_embedding"] = normal(
            (max(config.num_images, 1), config.appearance_embedding_dim), 0.1,
            generator)
    return params


def tp_window(rank: int, w: int, f_l: int) -> Tuple[slice, Tuple[int, int]]:
    """The window of rank ``rank`` of the feature-sharded hash ensemble,
    which holds columns [rank*w, (rank+1)*w) of the [E, W] table (column c
    is feature c % f_l of logical table c // f_l): the logical tables it
    touches, and the zero columns (left, right) that pad its columns to
    them (at most f_l - 1 at either end)."""
    lo, hi = rank * w, (rank + 1) * w
    h0, h1 = lo // f_l, -(-hi // f_l)
    return slice(h0, h1), (lo - h0 * f_l, h1 * f_l - hi)


def normalize_positions(positions, aabb_min, aabb_max):
    return (positions - aabb_min) / (aabb_max - aabb_min)


def prepare_field(field_params, config: ModelConfig,
                  levels: HashGridLevels, table_layout=None) -> Dict:
    """Per-params table preparation, hoisted out of the sample-chunk loop:
    the xz-quad gather operand [E, 4W] in the table dtype (kernel B3 on
    CUDA) next to the MLP parameters (and the appearance embedding).

    ``table_layout`` (set by a trainer over several ranks, JAX
    ``replicate_sharding``): ``("rows", mesh)``, the ZeRO-3 table, holds the
    rank's [E/n, W] entry shard: the cast runs on the shard, the cast rows
    are all-gathered (half the bytes of f32 at bf16) and the quad is built
    on the whole table; the backward reduce-scatters the folded gradient in
    the table dtype onto the shard. ``("cols", mesh)``, the feature-sharded
    table, holds [E, W/n] columns (on the single grid, its features): the
    quad is built on them and the encode blends them (``encode_tables``)
    or encodes them (``encode_grid``). A rank's columns of the hash
    ensemble may cut a logical table at either end (``tp_window``): zero
    columns pad them to the whole tables they touch before the quad is
    built. A zero column adds exact zeros to the blend and to the code's
    gradient, and the pad's backward drops its gradient before Adam."""
    dtype = getattr(torch, config.table_dtype)
    table = field_params.table
    kind, mesh = table_layout or (None, None)
    tables = None
    if kind == "rows":
        table = mesh.all_gather_rows_grad(table.to(dtype))
    elif kind == "cols" and config.use_hash_ensemble:
        tables, pad = tp_window(mesh.rank, table.shape[1], table_row_width(config)[1])
        if any(pad):
            table = F.pad(table.to(dtype), pad)
    quad = build_quad_table(table, levels, dtype)
    prepared = {"table_quad": quad, "mlp_base": field_params.mlp_base,
                "mlp_head": field_params.mlp_head}
    if kind == "cols":
        prepared["tp_mesh"] = mesh
        prepared["tp_tables"] = tables
    if "appearance_embedding" in field_params:
        prepared["appearance_embedding"] = field_params.appearance_embedding
    return prepared


def encode_tables(fparams: Dict, norm: torch.Tensor, code: torch.Tensor,
                  levels: HashGridLevels, features_per_logical: int,
                  smoothstep: bool) -> torch.Tensor:
    """``hash_encode_blended`` of the prepared quad table. Under the
    feature-sharded layout (``fparams["tp_mesh"]``) each rank blends the
    logical tables of its window (``fparams["tp_tables"]``, zero-padded
    where its columns cut one) over the rows of every rank (inputs
    all-gathered) and the partial sums are reduce-scattered back to each
    rank's rows; rows that every rank holds alike (``fparams["tp_rows"] ==
    "replicated"``, the occupancy update) are encoded in place and the
    partial sums all-reduced."""
    mesh = fparams.get("tp_mesh")
    quad = fparams["table_quad"]
    if mesh is None:
        return hash_encode_blended(quad, norm, code, levels,
                                   features_per_logical, smoothstep)
    cols = fparams["tp_tables"]
    if fparams.get("tp_rows") == "replicated":
        return mesh.all_reduce_sum(hash_encode_blended(
            quad, norm, code[:, cols], levels, features_per_logical, smoothstep))
    part = hash_encode_blended(quad, mesh.all_gather_rows_grad(norm),
                               mesh.all_gather_rows_grad(code)[:, cols], levels,
                               features_per_logical, smoothstep)
    return mesh.reduce_scatter_rows_grad(part)


def encode_grid(fparams: Dict, norm: torch.Tensor,
                levels: HashGridLevels) -> torch.Tensor:
    """``hash_encode`` of the prepared single-grid quad table, [N, L*W].
    Under the feature-sharded layout (``fparams["tp_mesh"]``) each rank
    holds w = W/n columns and encodes them over the rows of every rank
    (positions all-gathered); each rank's [rows, L, w] features go into
    its slot of a zero [rows, L, W] buffer, which is reduce-scattered back
    to each rank's rows: every entry is one rank's value plus zeros, exact.
    Rows that every rank holds alike (``fparams["tp_rows"] ==
    "replicated"``, the occupancy update) are encoded in place and the
    ranks' columns all-gathered."""
    mesh = fparams.get("tp_mesh")
    quad = fparams["table_quad"]
    if mesh is None:
        return hash_encode(quad, norm, levels)
    L, w, n = levels.n_levels, quad.shape[1] // 4, mesh.size
    if fparams.get("tp_rows") == "replicated":
        part = mesh.all_gather_rows(hash_encode(quad, norm, levels))  # [n*N, L*w]
        return part.view(n, -1, L, w).permute(1, 2, 0, 3).reshape(-1, L * n * w)
    part = hash_encode(quad, mesh.all_gather_rows_grad(norm), levels).view(-1, L, w)
    slots = F.pad(part, (mesh.rank * w, (n - 1 - mesh.rank) * w))  # [rows, L, W]
    return mesh.reduce_scatter_rows_grad(slots.reshape(-1, L * n * w))


def field_density(fparams: Dict, positions_world: torch.Tensor,
                  time_codes: Optional[torch.Tensor], config: ModelConfig,
                  levels: HashGridLevels, aabb_min, aabb_max,
                  window_hash: Optional[float] = None,
                  compute_dtype: torch.dtype = torch.bfloat16):
    """[N, 3] world positions -> (density [N] f32, geo features [N, G])."""
    norm = normalize_positions(positions_world, aabb_min, aabb_max)
    selector = ((norm > 0.0) & (norm < 1.0)).all(dim=-1)
    norm = norm * selector[..., None]
    if config.use_hash_ensemble:
        he = config.hash_ensemble
        code = effective_blend_code(time_codes, window_hash,
                                    he.n_hash_encodings,
                                    he.disable_initial_hash_ensemble,
                                    he.use_soft_transition)
        base_in = encode_tables(
            fparams, norm, code, levels, table_row_width(config)[1],
            he.hash_encoding.interpolation == "Smoothstep")
    else:
        base_in = encode_grid(fparams, norm, levels)
    h = mlp_apply(config.use_fused_mlp)(fparams["mlp_base"], base_in, None,
                                        compute_dtype)
    density = trunc_exp(h[..., 0]) * selector
    return density, h[..., 1:]


def field_rgb(fparams: Dict, directions: torch.Tensor, geo: torch.Tensor,
              config: ModelConfig,
              camera_indices: Optional[torch.Tensor] = None,
              train: bool = True,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[N, 3] unit view directions + [N, G] geo features -> [N, 3] rgb. With
    the appearance embedding, training rows take their camera's code and
    eval rows (or rows without camera indices) zeros."""
    if config.spherical_harmonics_degree > 0:
        d_enc = sh_encoding(directions, config.spherical_harmonics_degree)
    else:
        d_enc = shift_directions(directions)
    inputs = [d_enc, geo]
    if config.use_appearance_embedding:
        emb = fparams["appearance_embedding"]
        if train and camera_indices is not None:
            # embedding's backward sums each camera's rows in parallel
            # segments; index_put_'s walks a camera's run in one warp
            inputs.append(F.embedding(camera_indices, emb))
        else:
            inputs.append(torch.zeros(directions.shape[0], emb.shape[-1],
                                      dtype=emb.dtype, device=emb.device))
    h = torch.cat([i.to(torch.float32) for i in inputs], dim=-1)
    return mlp_apply(config.use_fused_mlp)(fparams["mlp_head"], h, "sigmoid",
                                           compute_dtype)
