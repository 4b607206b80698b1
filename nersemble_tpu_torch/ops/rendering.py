"""Volume rendering on fixed-shape masked [R, S] samples (port of
nersemble_tpu/ops/rendering.py)."""

import torch


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``sum_{j<i} x_j``: the inclusive cumsum shifted by one. The JAX
    version subtracts ``x`` from the inclusive sum, which is the same where
    the inputs are finite and inf - inf = NaN where one overflows."""
    inclusive = torch.cumsum(x, dim=dim)
    n = x.shape[dim]
    return torch.cat([torch.zeros_like(x.narrow(dim, 0, 1)),
                      inclusive.narrow(dim, 0, n - 1)], dim=dim)


def render_weights(sigmas, t_starts, t_ends, mask):
    """``w_i = T_i (1 - exp(-sigma_i delta_i))``, ``T_i = exp(-sum_{j<i}
    sigma_j delta_j)``; masked slots contribute 0 (selected away, so that an
    overflowed density there does not give inf * 0). Returns (weights, T)."""
    mask_f = mask.to(sigmas.dtype)
    sigma_delta = torch.where(mask, sigmas * (t_ends - t_starts),
                              torch.zeros_like(sigmas))
    trans = torch.exp(-exclusive_cumsum(sigma_delta, dim=-1))
    alphas = 1.0 - torch.exp(-sigma_delta)
    return trans * alphas * mask_f, trans


def accumulate(weights, values=None):
    """Per-ray reduction: [R, S] (x [R, S, C]) -> [R, C] (or [R, 1])."""
    if values is None:
        return weights.sum(dim=-1, keepdim=True)
    return torch.einsum("rs,rsc->rc", weights, values)


def render_rgb(weights, rgbs, background_color):
    """Composite [R, S, 3] colours over the background."""
    return accumulate(weights, rgbs) \
        + (1.0 - accumulate(weights)) * background_color[None, :]


def render_depth_expected(weights, t_starts, t_ends, eps: float = 1e-10):
    """Accumulation-normalized expected depth of the sample midpoints."""
    mids = (t_starts + t_ends) * 0.5
    return accumulate(weights, mids[..., None]) / (accumulate(weights) + eps)


def render_accumulation(weights):
    return accumulate(weights)


def render_expected_value(weights, values):
    """Volume-render per-sample vectors (e.g. the SE(3) offsets)."""
    return accumulate(weights, values)
