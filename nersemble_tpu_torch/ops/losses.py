"""Supervision losses on the [R, S] masked-sample layout (port of
nersemble_tpu/ops/losses.py).

Subset means are masked sums over clamped counts (fixed shapes; an empty
selection gives 0, which the weighted sum of losses treats like the
reference's skipped term). With ``mesh`` (a ``parallel.mesh.DataMesh``) the
rays are one rank's slice of the batch: the counts are all-reduced, so each
rank's loss is its own sum over the batch's count and the ranks' losses add
up to the batch's.
"""

import math
from typing import Optional

import torch


def masked_mean(values: torch.Tensor, mask: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    m = mask.to(values.dtype)
    count = torch.sum(m)
    if mesh is not None:
        count = mesh.all_reduce_sum(count)
    return torch.sum(values * m) / torch.clamp(count, min=1.0)


def mean(values: torch.Tensor, mesh=None) -> torch.Tensor:
    """The mean over the batch (every rank holds as many elements)."""
    return torch.sum(values) / (values.numel() * (1 if mesh is None else mesh.size))


def masked_rgb_loss(rgb_pred: torch.Tensor, rgb_gt: torch.Tensor,
                    alpha_per_ray: Optional[torch.Tensor], use_masked: bool,
                    alpha_mask_threshold: float, mesh=None) -> torch.Tensor:
    """MSE over rays, optionally only foreground rays (alpha > threshold)."""
    sq = (rgb_pred - rgb_gt) ** 2  # [R, 3]
    if use_masked and alpha_per_ray is not None:
        mask = (alpha_per_ray > alpha_mask_threshold)[:, None].expand(sq.shape)
        return masked_mean(sq, mask, mesh)
    return mean(sq, mesh)


def alpha_loss(accumulation: torch.Tensor, alpha_per_ray: torch.Tensor,
               mesh=None) -> torch.Tensor:
    """L1 between accumulation and GT alpha on background rays (alpha < 1)."""
    return masked_mean(torch.abs(accumulation[:, 0] - alpha_per_ray),
                        alpha_per_ray < 1.0, mesh)


def empty_loss(weights, t_starts, t_ends, sample_mask, depth_per_ray,
               eps_depth: float, mesh=None) -> torch.Tensor:
    """Mean squared weight of the valid samples in front of the GT depth
    (midpoint < depth - eps, rays with depth > 0)."""
    mids = (t_starts + t_ends) * 0.5
    depth = depth_per_ray[:, None]
    sel = (depth > 0) & (mids < depth - eps_depth) & sample_mask
    return masked_mean(weights ** 2, sel, mesh)


def near_loss(weights, t_starts, t_ends, sample_mask, depth_per_ray,
              eps_depth: float, mesh=None) -> torch.Tensor:
    """Accumulated weight vs a Gaussian-CDF ramp inside depth +- eps. The
    reference passes ``(eps/3)**2`` as the Normal's std (not variance);
    kept for parity."""
    mids = (t_starts + t_ends) * 0.5
    depth = depth_per_ray[:, None]
    sel = ((depth > 0) & (depth - eps_depth <= mids)
           & (mids <= depth + eps_depth) & sample_mask)
    accumulated = torch.cumsum(weights * sample_mask.to(weights.dtype), dim=-1)
    std = (eps_depth / 3.0) ** 2
    expected = 0.5 * (1.0 + torch.erf((mids - depth) / (std * math.sqrt(2.0))))
    return masked_mean((accumulated - expected) ** 2, sel, mesh)


def depth_loss(depth_pred: torch.Tensor, depth_per_ray: torch.Tensor,
               mesh=None) -> torch.Tensor:
    """MSE on rays with valid GT depth (> 0)."""
    return masked_mean((depth_per_ray - depth_pred[:, 0]) ** 2,
                        depth_per_ray > 0, mesh)
