"""mip-NeRF 360 distortion loss in closed form over [R, S] samples (port of
nersemble_tpu/ops/distortion.py).

With prefix sums over the ascending sample midpoints the O(S^2) pairwise
term is O(S) per ray:

    sum_{i != j} w_i w_j |m_i - m_j| = 2 * sum_i w_i (m_i A_i - B_i),
    A_i = sum_{j<i} w_j,  B_i = sum_{j<i} w_j m_j,

plus the intra-sample term ``(1/3) sum_i w_i^2 delta_i``; averaged over rays.
"""

import torch

from nersemble_tpu_torch.ops.losses import masked_mean, mean
from nersemble_tpu_torch.ops.rendering import exclusive_cumsum


def distortion_loss(weights, t_starts, t_ends, mask, ray_mask=None,
                    mesh=None) -> torch.Tensor:
    """weights/t_starts/t_ends/mask [R, S]; ``ray_mask`` [R] selects the rays
    that enter the mean; ``mesh`` as in ops/losses.py."""
    m = mask.to(weights.dtype)
    w = weights * m
    mids = (t_starts + t_ends) * 0.5
    deltas = t_ends - t_starts
    a = exclusive_cumsum(w, dim=-1)
    b = exclusive_cumsum(w * mids, dim=-1)
    bi = 2.0 * torch.sum(w * (mids * a - b), dim=-1)
    uni = torch.sum(w * w * deltas * m, dim=-1) / 3.0
    per_ray = bi + uni
    if ray_mask is not None:
        return masked_mean(per_ray, ray_mask, mesh)
    return mean(per_ray, mesh)


def distortion_loss_reference(weights, mids, deltas) -> torch.Tensor:
    """O(S^2) pairwise form for one ray ([S] tensors), for tests."""
    pair = torch.abs(mids[:, None] - mids[None, :])
    bi = torch.sum(weights[:, None] * weights[None, :] * pair)
    return bi + torch.sum(weights * weights * deltas) / 3.0
