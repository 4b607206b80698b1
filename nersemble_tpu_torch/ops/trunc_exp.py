"""Density activation (port of nersemble_tpu/ops/trunc_exp.py).

``exp`` computed in float32 whatever the input dtype: bf16 exp would
quantize density too coarsely for volume rendering. The backward clamps the
input to [-15, 15] before differentiating, which keeps large densities from
exploding the gradient.
"""

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x32 = x.to(torch.float32)
        ctx.save_for_backward(x32)
        return torch.exp(x32)

    @staticmethod
    def backward(ctx, g):
        (x32,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x32, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
