"""Synthetic scenes for renders without a trained model: pinhole camera
rays and an occupancy grid (numpy, host side), and contrast for random
parameters."""

from typing import Dict

import numpy as np
import torch

SCENE_CENTRE = np.array([0.0, 0.5, -0.25], np.float32)  # default scene box


def pinhole_frame(height: int, width: int, timestep: int,
                  fov_y_deg: float = 60.0, distance: float = 8.0,
                  centre: np.ndarray = SCENE_CENTRE) -> Dict:
    """Rays of a pinhole camera ``distance`` from ``centre`` on the -x side,
    looking along +x (image up = +y, right = +z), as the ``image_rays`` dict
    ``Renderer.render_image`` takes."""
    eye = np.asarray(centre, np.float32) - np.array([distance, 0.0, 0.0],
                                                    np.float32)
    f = 0.5 * height / np.tan(np.deg2rad(0.5 * fov_y_deg))
    j, i = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    d = np.stack([np.full(j.shape, f, np.float32),
                  (height / 2 - j - 0.5).astype(np.float32),
                  (i + 0.5 - width / 2).astype(np.float32)], -1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n = height * width
    return {"height": height, "width": width,
            "origins": np.tile(eye, (n, 1)).astype(np.float32),
            "directions": d.astype(np.float32),
            "timesteps": np.full(n, timestep, np.int64)}


def synthetic_occupancy(resolution: int, fill: float, seed: int) -> np.ndarray:
    """Occupancy EMA state [G^3] for renders without a trained grid: a
    ``fill`` fraction of random cells plus the centre block (a quarter of
    the box per axis) set to 1, the rest 0."""
    rng = np.random.default_rng(seed)
    occ = rng.uniform(size=(resolution,) * 3) < fill
    c = slice(resolution // 2 - resolution // 8, resolution // 2 + resolution // 8)
    occ[c, c, c] = True
    return occ.reshape(-1).astype(np.float32)


# Factors that give a random init contrast, by state_dict key. The init
# draws the hash table from U(+-1e-4), the time codes at 0.01/sqrt(dim) and
# the warp head at 1e-5, so its field is near constant over position, time
# and deformation; scaled, all three change the rendered frames.
CONTRAST_SCALES = {"field.table": 3e3, "time_embedding": 100.0,
                   "time_embedding_deformation": 100.0,
                   "deformation.head_rv.w": 3e3}


def add_contrast(params):
    """Scale a random init's parameters in place by ``CONTRAST_SCALES``."""
    state = params.state_dict()
    with torch.no_grad():
        for key, factor in CONTRAST_SCALES.items():
            if key in state:
                state[key].mul_(factor)
    return params
