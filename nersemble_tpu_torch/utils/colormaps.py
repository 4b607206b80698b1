"""Colormaps for depth / accumulation / error / scene-flow visualizations
(port of nersemble_tpu/utils/colormaps.py; matplotlib's viridis and turbo
are lookup tables in ``colormap_tables.py``).
"""

import numpy as np

from nersemble_tpu_torch.utils.colormap_tables import TURBO, VIRIDIS

_TABLES = {"viridis": VIRIDIS, "turbo": TURBO}


def apply_colormap(values: np.ndarray, cmap: str = "viridis") -> np.ndarray:
    """[H, W] or [H, W, 1] values in [0, 1] -> [H, W, 3] float RGB. Index
    ``int(v * 256)`` in the input's precision, clipped to 255, NaN -> black:
    matplotlib's ``Colormap.__call__`` on floats."""
    values = np.asarray(values)
    if values.ndim == 3:
        values = values[..., 0]
    table = _TABLES[cmap]
    n = table.shape[0]
    scaled = np.clip(values, 0.0, 1.0) * n
    bad = np.isnan(scaled)
    idx = np.minimum(np.where(bad, 0, scaled).astype(np.int64), n - 1)
    mapped = table[idx]
    mapped[bad] = 0.0
    return mapped.astype(np.float32)


def apply_depth_colormap(depth: np.ndarray,
                         accumulation: np.ndarray = None,
                         near: float = None, far: float = None,
                         cmap: str = "turbo") -> np.ndarray:
    """Turbo-colormapped depth, optionally alpha-scaled by accumulation."""
    depth = np.asarray(depth)
    if depth.ndim == 3:
        depth = depth[..., 0]
    if near is None:
        near = float(np.percentile(depth, 2))
    if far is None:
        far = float(np.percentile(depth, 98))
    norm = np.clip((depth - near) / max(far - near, 1e-8), 0.0, 1.0)
    colored = apply_colormap(norm, cmap)
    if accumulation is not None:
        acc = np.asarray(accumulation)
        if acc.ndim == 3:
            acc = acc[..., 0]
        colored = colored * acc[..., None]
    return colored


def apply_scene_flow_colormap(flow: np.ndarray, max_magnitude: float = None
                              ) -> np.ndarray:
    """[H, W, 3] 3D offsets -> RGB: direction encoded in hue-like channels,
    magnitude in saturation (dreifus-style scene-flow visualization)."""
    flow = np.asarray(flow, np.float32)
    if max_magnitude is None:
        max_magnitude = max(float(np.abs(flow).max()), 1e-8)
    return np.clip(flow / (2 * max_magnitude) + 0.5, 0.0, 1.0)


def apply_error_colormap(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Per-pixel squared-error image, turbo-colored."""
    err = ((np.asarray(pred) - np.asarray(gt)) ** 2).mean(-1)
    return apply_colormap(err, "turbo")
