"""Image metrics (port of nersemble_tpu/utils/metrics.py: PSNR only; SSIM,
LPIPS and the masked variants come with the evaluation slice)."""

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(data_range ** 2
                              / torch.clamp(mse(pred, target), min=1e-12))
