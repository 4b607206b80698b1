"""SE(3) exponential map applied to points (port of nersemble_tpu/utils/se3.py).

Screw axes are ``[v, r]`` (translation first). Elementwise cross/dot
identities, no 3x3 matrices; Taylor fallbacks below ``|r|^2 < 1e-8`` with
the double-where guard, exactly as the JAX version.
"""

import torch

_EPS = 1e-8


def _coeffs(r: torch.Tensor):
    """cos(t), sin(t)/t, (1-cos t)/t^2, (t-sin t)/t^3 and t^2 for [..., 3] r."""
    t2 = torch.sum(r * r, dim=-1)
    small = t2 < _EPS
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2_safe)
    cos = torch.where(small, 1.0 - t2 / 2.0 + t2 * t2 / 24.0, torch.cos(theta))
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2_safe)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta)) / (theta * t2_safe))
    return cos, a, b, c, t2


def se3_apply(screw: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``exp(screw) p = cos(t) p + a (r x p) + b r (r . p) + V v``."""
    v, r = screw[..., :3], screw[..., 3:]
    cos, a, b, c, theta2 = _coeffs(r)
    rotated = (cos[..., None] * points
               + a[..., None] * torch.cross(r, points, dim=-1)
               + b[..., None] * r * torch.sum(r * points, dim=-1, keepdim=True))
    t = ((1.0 - c * theta2)[..., None] * v
         + b[..., None] * torch.cross(r, v, dim=-1)
         + c[..., None] * r * torch.sum(r * v, dim=-1, keepdim=True))
    return rotated + t
