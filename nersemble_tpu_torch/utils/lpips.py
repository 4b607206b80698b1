"""LPIPS perceptual metric, gated on locally available VGG weights (the
port's copy of nersemble_tpu/utils/lpips.py, in PyTorch on the caller's
device).

The reference uses torchmetrics' LPIPS with pretrained VGG-16
(reference: nersemble_instant_ngp.py:160, 448). Pretrained weights cannot be
downloaded here, so:
- If ``NERSEMBLE_LPIPS_WEIGHTS`` points to an .npz with VGG-16 conv weights
  (keys ``features.<i>.weight``/``bias``) plus LPIPS linear layer weights
  (keys ``lin<k>.model.1.weight``), LPIPS is evaluated.
- Otherwise ``lpips_or_none`` returns None and evaluation omits the metric
  (the JSON schema keeps the field as null).

The convolutions run in full float32: cuDNN's TF32 is switched off for the
call, so the metric does not depend on the process's TF32 setting.
"""

import os
from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nersemble_tpu_torch.utils.device import resolve_device

# torchvision VGG-16 ``features`` indices: conv layers, maxpool layers, and
# the LPIPS feature taps (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
_VGG_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG_POOLS = (4, 9, 16, 23)  # pool 30 sits after the last tap — never reached
_TAPS = (3, 8, 15, 22, 29)
# LPIPS input scaling layer constants (lpips/pretrained_networks.py)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


@lru_cache(maxsize=1)
def _load_weights() -> Optional[Dict[str, np.ndarray]]:
    path = os.environ.get("NERSEMBLE_LPIPS_WEIGHTS")
    if not path or not os.path.exists(path):
        return None
    with np.load(path) as data:
        return dict(data)


@lru_cache(maxsize=4)
def _device_weights(device: torch.device) -> Dict[str, torch.Tensor]:
    """The weights on ``device``, copied there once."""
    return {k: torch.from_numpy(v).to(device, torch.float32)
            for k, v in _load_weights().items()}


def lpips_available() -> bool:
    return _load_weights() is not None


def reset_lpips_cache() -> None:
    """Drop the cached weights (tests change NERSEMBLE_LPIPS_WEIGHTS)."""
    _load_weights.cache_clear()
    _device_weights.cache_clear()


def _vgg_taps(x: torch.Tensor, weights: Dict[str, torch.Tensor]):
    taps = []
    for i in range(_TAPS[-1] + 1):
        if i in _VGG_CONVS:
            # JAX "SAME" for a 3x3 stride-1 window: one pixel on each side
            x = F.conv2d(x, weights[f"features.{i}.weight"],
                         weights[f"features.{i}.bias"], padding=1)
        elif i in _VGG_POOLS:
            x = F.max_pool2d(x, 2)
        else:
            x = F.relu(x)
        if i in _TAPS:
            taps.append(x)
    return taps


def lpips_or_none(pred, target, device="cuda") -> Optional[float]:
    """[H, W, 3] numpy images in [0, 1] -> LPIPS(VGG) computed on
    ``device`` (the card unless the caller names another), or None if no
    weights are available."""
    if _load_weights() is None:
        return None
    device = resolve_device(device)
    weights = _device_weights(device)
    shift = torch.tensor(_SHIFT).view(1, 3, 1, 1).to(device)
    scale = torch.tensor(_SCALE).view(1, 3, 1, 1).to(device)

    def normalize(img):
        x = torch.as_tensor(np.asarray(img, np.float32)).to(device) * 2.0 - 1.0
        return (x.permute(2, 0, 1)[None] - shift) / scale  # NCHW

    cudnn = torch.backends.cudnn
    with torch.no_grad(), cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                                      deterministic=cudnn.deterministic,
                                      allow_tf32=False):
        fx = _vgg_taps(normalize(pred), weights)
        fy = _vgg_taps(normalize(target), weights)
        total = torch.zeros((), device=device)
        for k, (a, b) in enumerate(zip(fx, fy)):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            lin = weights[f"lin{k}.model.1.weight"][0, :, 0, 0]  # [C]
            total = total + torch.mean(
                torch.sum((a - b) ** 2 * lin[None, :, None, None], dim=1))
    return float(total)
