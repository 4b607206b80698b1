"""Windowed sinusoidal positional encoding (port of nersemble_tpu/ops/posenc.py).

Layout ``[sin(d0 f0), ..., sin(dD fF), cos(d0 f0), ..., (2*pi*x)]`` with the
Hann window applied per (dim, freq) pair to both halves.
"""

from typing import Optional

import numpy as np
import torch

from nersemble_tpu_torch.utils.device import device_constant
from nersemble_tpu_torch.utils.windows import posenc_window


def windowed_posenc(x: torch.Tensor,
                    num_frequencies: int,
                    min_freq_exp: float = 0.0,
                    max_freq_exp: Optional[float] = None,
                    include_input: bool = True,
                    window_param: Optional[float] = None) -> torch.Tensor:
    """Encode [..., D] -> [..., 2*D*num_frequencies (+ D)]."""
    if max_freq_exp is None:
        max_freq_exp = num_frequencies - 1
    scaled = 2.0 * np.pi * x
    freqs = device_constant(
        tuple((2.0 ** np.linspace(min_freq_exp, max_freq_exp,
                                  num_frequencies)).tolist()),
        x.dtype, x.device)
    angles = (scaled[..., None] * freqs).flatten(-2)  # [..., D*F], d-major
    encoded = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)

    if window_param is not None:
        window = posenc_window(window_param, min_freq_exp, max_freq_exp,
                               num_frequencies, x.device).to(x.dtype)
        window = window.repeat(x.shape[-1])
        encoded = torch.cat([window, window]) * encoded

    if include_input:
        encoded = torch.cat([encoded, scaled], dim=-1)
    return encoded


def posenc_out_dim(in_dim: int, num_frequencies: int,
                   include_input: bool = True) -> int:
    return 2 * in_dim * num_frequencies + (in_dim if include_input else 0)
