"""Direction encodings of the colour head (port of nersemble_tpu/ops/sh.py).

``shift_directions`` is the identity encoding's input convention (tcnn takes
directions in [0, 1]); ``sh_encoding`` is the closed-form real spherical
harmonics basis of degree 1-4 (1, 4, 9 or 16 coefficients) at raw unit
directions, tcnn's SphericalHarmonics encoding.
"""

import torch


def shift_directions(directions: torch.Tensor) -> torch.Tensor:
    """Map unit directions from [-1, 1] to [0, 1] (tcnn input convention)."""
    return (directions + 1.0) / 2.0


def unshift_directions(shifted: torch.Tensor) -> torch.Tensor:
    return shifted * 2.0 - 1.0


def sh_encoding(directions: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis evaluated at unit [..., 3] directions -> [..., degree**2]."""
    if not 1 <= degree <= 4:
        raise ValueError(f"SH degree must be in [1, 4], got {degree}")
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z

    components = [0.28209479177387814 * torch.ones_like(x)]
    if degree > 1:
        components += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree > 2:
        components += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
        ]
    if degree > 3:
        components += [
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ]
    return torch.stack(components, dim=-1)


def sh_out_dim(degree: int) -> int:
    return degree ** 2
