"""Direction input convention of the colour head (port of the
``shift_directions`` helper of nersemble_tpu/ops/sh.py). The spherical
harmonics basis waits for a config that uses it (the flagship uses the
identity encoding of shifted directions)."""

import torch


def shift_directions(directions: torch.Tensor) -> torch.Tensor:
    """Map unit directions from [-1, 1] to [0, 1] (tcnn input convention)."""
    return (directions + 1.0) / 2.0
