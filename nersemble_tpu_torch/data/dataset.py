"""Image dataset with bounded RAM cache, color correction, and alpha blending
(the port's copy of nersemble_tpu/data/dataset.py; images are decoded by
utils/png.py and resized here instead of by PIL).

Per image:

- ``rgb`` [H, W, 3] f32 in [0, 1]: affine color correction (3x4 matrix per
  camera) applied in linear [0,1] space, then alpha-blended against the
  configured background color using the separately stored alpha map.
- ``alpha`` [H, W] f32 in [0, 1] (if alpha maps are enabled).
- ``depth`` [H, W] f32 metric (0 = invalid) — decoded 16-bit quantized depth,
  nearest-resized, outliers outside [0.8, 1.4] m zeroed, scaled by the world
  scale factor.

Resizing: images stored at the probed size pass unchanged (the case of
every capture the dataparser sizes). An rgb or alpha map of another size is
resized with PIL's antialiased BILINEAR filter and a depth map with PIL's
NEAREST rule, as the JAX package resizes them; ``resize_bilinear`` and
``resize_nearest`` reproduce PIL bit for bit.

The cache stores at most ``max_cached_items`` decoded items, optionally
uint8-compressed (~4x smaller, lossy) like the reference's ~200 GB RAM cache.
"""

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from nersemble_tpu_torch.config import DataConfig
from nersemble_tpu_torch.data.dataparser import DataparserOutputs
from nersemble_tpu_torch.utils import png
from nersemble_tpu_torch.utils.quantization import DepthQuantizer

_ALPHA_BG = {"white": 1.0, "black": 0.0}


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each output pixel along one axis, as PIL's NEAREST
    resize computes it: the pixel centre (i + 0.5) * n_in / n_out, summed
    step by step in double precision, truncated."""
    scale = n_in / n_out
    steps = np.full(n_out, scale)
    steps[0] = scale * 0.5
    return np.minimum(np.cumsum(steps).astype(np.int64), n_in - 1)


def resize_nearest(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H, W, ...] -> [size[1], size[0], ...] by PIL's NEAREST rule."""
    width, height = size
    return image[_nearest_index(image.shape[0], height)][:, _nearest_index(image.shape[1], width)]


# PIL's fixed-point weights of the 8-bit resample passes (Resample.c)
_PRECISION_BITS = 32 - 8 - 2


def _bilinear_taps(n_in: int, n_out: int):
    """(first source index [n_out], fixed-point weights [n_out, taps]) of
    PIL's triangle filter along one axis (Resample.c precompute_coeffs and
    normalize_coeffs_8bpc): support max(n_in / n_out, 1), window centred
    on (i + 0.5) * scale and clipped to the image, weights normalised in
    double precision (summed tap by tap, as PIL does), then rounded to
    ``_PRECISION_BITS`` fraction bits. Taps past the window weigh 0."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = filterscale  # the bilinear filter's support is 1
    taps = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    # C's (int) conversion truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), n_in) - xmin
    x = np.arange(taps)
    w = np.abs(((x + xmin[:, None]).astype(np.float64) - center[:, None] + 0.5)
               * (1.0 / filterscale))
    w = np.where((x < xmax[:, None]) & (w < 1.0), 1.0 - w, 0.0)
    total = np.zeros(n_out)
    for k in range(taps):
        total = total + w[:, k]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    return xmin, np.trunc(0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)


def _bilinear_pass(image: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """One 8-bit pass of PIL's resample along ``axis``: the weighted sum of
    each window in integers, rounded at half, clipped to uint8."""
    n_in = image.shape[axis]
    xmin, weights = _bilinear_taps(n_in, n_out)
    index = np.minimum(xmin[:, None] + np.arange(weights.shape[1]), n_in - 1)
    src = np.moveaxis(image, axis, 0).astype(np.int64)
    acc = np.full((n_out,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for k in range(weights.shape[1]):
        wk = weights[:, k].reshape((n_out,) + (1,) * (src.ndim - 1))
        acc += src[index[:, k]] * wk
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> [size[1], size[0], ...] by PIL's
    antialiased BILINEAR resize (``Image.resize(size, Image.BILINEAR)``),
    bit for bit: the horizontal pass first, rounded to uint8, then the
    vertical pass; an axis whose size does not change is not resampled."""
    if image.dtype != np.uint8:
        raise TypeError(f"resize_bilinear takes uint8 images, not {image.dtype}")
    width, height = size
    out = image
    if width != image.shape[1]:
        out = _bilinear_pass(out, width, axis=1)
    if height != image.shape[0]:
        out = _bilinear_pass(out, height, axis=0)
    return out


def _resize(image: np.ndarray, size, nearest: bool = False) -> np.ndarray:
    if image.shape[1::-1] == tuple(size):
        return image
    if nearest:
        return resize_nearest(image, size)
    return resize_bilinear(image, size)


class NeRSembleDataset:
    def __init__(self, outputs: DataparserOutputs, config: DataConfig):
        self.outputs = outputs
        self.config = config
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._bg = _ALPHA_BG[config.alpha_channel_color]

    def __len__(self) -> int:
        return self.outputs.n_images

    # -- loading -------------------------------------------------------------

    def _load_item(self, image_idx: int) -> Dict[str, np.ndarray]:
        out = self.outputs
        size = (out.image_width, out.image_height)
        rgb = png.imread(out.image_paths[image_idx])
        if rgb.ndim == 2:
            rgb = np.repeat(rgb[:, :, None], 3, axis=2)
        rgb = _resize(rgb[..., :3], size)
        rgb = rgb.astype(np.float32) / 255.0

        if out.color_correction_paths is not None:
            cc = np.load(out.color_correction_paths[image_idx])
            rgb = rgb @ cc[:3, :3] + cc[np.newaxis, :3, 3]
            rgb = np.clip(rgb, 0.0, 1.0)
        # quantize like the reference (which re-saves uint8 after correction)
        rgb = (rgb * 255).round().astype(np.uint8).astype(np.float32) / 255.0

        item = {"rgb": rgb}

        if out.alpha_paths is not None:
            alpha = png.imread(out.alpha_paths[image_idx])
            if alpha.ndim == 3:
                alpha = alpha[..., 0]
            alpha = _resize(alpha, size).astype(np.float32) / 255.0
            item["alpha"] = alpha
            # blend against the background color (nerfstudio get_image)
            item["rgb"] = alpha[..., None] * rgb + (1 - alpha[..., None]) * self._bg

        if out.depth_paths is not None:
            path = out.depth_paths[image_idx]
            if not Path(path).exists():
                depth = np.zeros((out.image_height, out.image_width), np.float32)
            else:
                quantized = png.imread(path)
                depth = DepthQuantizer().decode(quantized).astype(np.float32)
                depth = _resize(depth, size, nearest=True).copy()
                outlier = (depth < 0.8) | (depth > 1.4)
                depth[outlier] = 0.0
                depth = depth * self.config.scale_factor
            item["depth"] = depth

        return item

    def _compress(self, item):
        if not self.config.use_cache_compression:
            return item
        item = dict(item)
        item["rgb"] = (item["rgb"] * 255).round().astype(np.uint8)
        return item

    def _uncompress(self, item):
        if not self.config.use_cache_compression:
            return item
        item = dict(item)
        item["rgb"] = item["rgb"].astype(np.float32) / 255.0
        return item

    def __getitem__(self, image_idx: int) -> Dict[str, np.ndarray]:
        if image_idx in self._cache:
            return self._uncompress(self._cache[image_idx])
        item = self._load_item(image_idx)
        limit = self.config.max_cached_items
        if limit == -1 or len(self._cache) < limit:
            self._cache[image_idx] = self._compress(item)
        return item
