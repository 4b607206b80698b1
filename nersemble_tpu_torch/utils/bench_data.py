"""The train-step bench's fixed inputs: the synthetic occupancy grid and the
random ray batch of the JAX package's bench.py, drawn from the same numpy
seeds (the JAX bench takes the rays from ``__graft_entry__._example_rays(n,
T, seed=1)`` and then rgb, alpha and depth from ``default_rng(0)`` after
its grid)."""

from typing import Dict, Optional

import numpy as np
import torch

from nersemble_tpu_torch.utils.cameras import synthetic_occupancy

GRID_SEED, RAY_SEED = 0, 1
STEADY_STATE_FILL = 63188  # valid samples/step of the converged static run


def bench_grid(resolution: int, fill: float = 0.05) -> torch.Tensor:
    """bench.py's grid as an occupancy state [G^3]: a ``fill`` fraction of
    random cells plus the centre block, from ``default_rng(0)``."""
    return torch.from_numpy(synthetic_occupancy(resolution, fill, GRID_SEED))


def bench_batch(n_rays: int, n_timesteps: int, grid_resolution: Optional[int],
                device) -> Dict[str, torch.Tensor]:
    """bench.py's fixed random batch on ``device``. ``grid_resolution``: the
    synthetic grid drawn from the same generator first (None when the grid
    comes from a run, as with bench.py's ``--from-run``)."""
    rng = np.random.default_rng(RAY_SEED)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32) \
        * np.array([0.05, 0.3, 0.3]) + np.array([1.0, 0.0, 0.0])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    timesteps = rng.integers(0, n_timesteps, n_rays)
    rng = np.random.default_rng(GRID_SEED)
    if grid_resolution is not None:
        rng.uniform(size=(grid_resolution,) * 3)  # bench.py draws its grid first
    batch = {
        "origins": np.tile(np.array([[-8.0, 0.0, 0.0]], np.float32), (n_rays, 1)),
        "directions": d.astype(np.float32),
        "timesteps": timesteps.astype(np.int64),
        "rgb": rng.uniform(size=(n_rays, 3)).astype(np.float32),
        "alpha": rng.uniform(size=n_rays).astype(np.float32),
        "depth": rng.uniform(7.5, 9.5, n_rays).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
