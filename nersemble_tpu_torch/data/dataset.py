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
every capture the dataparser sizes); depth maps of another size are
resized with PIL's NEAREST rule, which ``resize_nearest`` reproduces bit
for bit. An rgb or alpha map of another size would need PIL's antialiased
BILINEAR, which is not ported (ROADMAP A5): it raises.

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


def _resize(image: np.ndarray, size, nearest: bool = False) -> np.ndarray:
    if image.shape[1::-1] == tuple(size):
        return image
    if nearest:
        return resize_nearest(image, size)
    raise NotImplementedError(
        f"resizing an image from {image.shape[1]}x{image.shape[0]} to "
        f"{size[0]}x{size[1]} needs PIL's BILINEAR filter, which is not "
        f"ported (ROADMAP A5)")


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
