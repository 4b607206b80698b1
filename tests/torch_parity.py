"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: arrays cross between the frameworks as numpy."""

import sys
from pathlib import Path

import jax
import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # __graft_entry__ lives at the repo root
    sys.path.insert(0, str(REPO))


def to_numpy_tree(tree):
    """JAX pytree -> the same nesting with numpy leaves."""
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x, dtype=None):
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    arr = np.array(x)
    out = torch.from_numpy(arr)
    return out if dtype is None else out.to(dtype)


def n(x):
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def example_rays(n_rays: int, n_timesteps: int, seed: int = 0):
    """Rays from x = -8 toward the scene box (``__graft_entry__._example_rays``
    as numpy)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32) \
        * np.array([0.05, 0.3, 0.3], np.float32) + np.array([1.0, 0.0, 0.0],
                                                            np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {
        "origins": np.tile(np.array([[-8.0, 0.0, 0.0]], np.float32),
                           (n_rays, 1)),
        "directions": d.astype(np.float32),
        "timesteps": rng.integers(0, n_timesteps, n_rays).astype(np.int32),
    }
