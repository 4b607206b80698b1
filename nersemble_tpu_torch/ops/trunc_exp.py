"""Density activation (forward of nersemble_tpu/ops/trunc_exp.py).

``exp`` computed in float32 whatever the input dtype: bf16 exp would
quantize density too coarsely for volume rendering. The clamped backward
arrives with the training slice.
"""

import torch


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.to(torch.float32))
