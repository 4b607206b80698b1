"""Image metrics (port of nersemble_tpu/utils/metrics.py): PSNR, SSIM, MSE
and their masked variants.

SSIM follows the torchmetrics/Wang et al. defaults: gaussian window 11x11
sigma 1.5, k1=0.01, k2=0.03, data_range=1.0, per channel (a depthwise valid
convolution) then averaged, with the moments projected back to the
feasible set where the f32 ``mu_xx - mu_x**2`` cancellation breaks them.

LPIPS needs pretrained VGG weights (``NERSEMBLE_LPIPS_WEIGHTS``, see
utils/lpips.py); without them it is None, as in the JAX package. The metrics
run on the device the caller names: the card unless the caller asks for the
CPU (``utils/device.resolve_device``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from nersemble_tpu_torch.utils.device import resolve_device
from nersemble_tpu_torch.utils.lpips import lpips_or_none


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(data_range ** 2
                              / torch.clamp(mse(pred, target), min=1e-12))


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """[H, W, C] images -> scalar SSIM (valid-window convolution)."""
    channels = pred.shape[-1]
    kernel = _gaussian_kernel(kernel_size, sigma, pred.device)
    weight = kernel[None, None].expand(channels, 1, -1, -1)

    def filt(img):
        # [H, W, C] -> [1, C, H, W], one filter per channel
        return F.conv2d(img.permute(2, 0, 1)[None], weight, groups=channels)[0]

    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    mu_x = filt(pred)
    mu_y = filt(target)
    mu_xx = filt(pred * pred)
    mu_yy = filt(target * target)
    mu_xy = filt(pred * target)

    var_x = torch.clamp(mu_xx - mu_x ** 2, min=0.0)
    var_y = torch.clamp(mu_yy - mu_y ** 2, min=0.0)
    cov_bound = torch.sqrt(var_x * var_y)
    cov = torch.clamp(mu_xy - mu_x * mu_y, -cov_bound, cov_bound)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * mu_x * mu_y + c1) * (2 * cov + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2)
    return torch.mean(num / den)


def apply_alpha_mask(image: np.ndarray, alpha: np.ndarray,
                     background: float = 1.0) -> np.ndarray:
    """Blend an [H, W, 3] float image against the background with [H, W]
    alpha — the masked-METRIC preprocessing, in float."""
    a = alpha[..., None]
    return a * image + (1 - a) * background


def image_metrics(pred: np.ndarray, gt: np.ndarray, alpha=None, device="cuda"):
    """(regular, masked) dicts of psnr/ssim/mse/lpips for one [H, W, 3] pair,
    computed on ``device`` (the card unless the caller names another). The
    masked variants blend both images against the background with the GT
    alpha map first; ``masked`` values are None when ``alpha`` is None."""
    device = resolve_device(device)

    def bundle(p, g):
        pt = torch.as_tensor(np.asarray(p, np.float32), device=device)
        gt_ = torch.as_tensor(np.asarray(g, np.float32), device=device)
        return {
            "psnr": float(psnr(pt, gt_)),
            "ssim": float(ssim(pt, gt_)),
            "mse": float(mse(pt, gt_)),
            "lpips": lpips_or_none(p, g, device),
        }

    regular = bundle(pred, gt)
    masked = {k: None for k in regular}
    if alpha is not None:
        masked = bundle(apply_alpha_mask(pred, alpha),
                        apply_alpha_mask(gt, alpha))
    return regular, masked


def perform_alpha_blending(image: np.ndarray, alpha_map: np.ndarray
                           ) -> np.ndarray:
    """uint8-quantized white-background blend (the masked-JOD frame
    preprocessing): blend in float, clip, truncate back to uint8."""
    if image.dtype != np.uint8 or alpha_map.dtype != np.uint8:
        raise TypeError("perform_alpha_blending takes uint8 image and alpha")
    a = (alpha_map / 255.0)
    if a.ndim == image.ndim - 1:
        a = a[..., None]
    out = a * (image / 255.0) + (1 - a)
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)
