"""Binary occupancy grid with EMA updates (port of
nersemble_tpu/ops/occupancy.py).

The grid state is one [L*G^3] f32 tensor; binaries are
``occs > min(mean(occs), occ_thre)``, optionally ANDed with the camera
frustum grid. Every 16 steps the trainer updates it: during warm-up every
cell is probed, after it half the probes go to uniform cells and half to
currently occupied ones (inverse CDF over the binaries); each probe is
jittered inside its cell and evaluated at a random timestep, and
``occs[idx] = max(occs[idx] * decay, density * step)``.

The random draws (``OccupancyDraws``) can be passed in, so tests can feed
the JAX package's draws; otherwise a ``torch.Generator`` makes them.

``frustum_culling_grid`` is the host-side precompute of the mask that the
trainer passes to ``binaries`` as its frustum grid.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


def occupancy_binaries(occs: torch.Tensor, occ_thre: float,
                       frustum_grid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[L*G^3] EMA densities -> flat binaries, threshold min(mean, occ_thre)
    like nerfacc. The frustum-culling grid masks the base level only."""
    binaries = occs > torch.clamp(occs.mean(), max=occ_thre)
    if frustum_grid is not None:
        f = frustum_grid.reshape(-1)
        binaries = binaries.clone()
        binaries[:f.shape[0]] &= f
    return binaries


class OccupancyDraws(NamedTuple):
    """The random numbers of one update: ``cell_jitter`` [M, 3] in [0, 1)
    (in-cell probe offsets), ``timesteps`` [M] int, and after warm-up
    ``uniform_idx`` [m] (uniform cells) and ``occupied_u`` [m] in [0, 1)
    (inverse-CDF draws over the occupied cells), M = 2m."""

    cell_jitter: torch.Tensor
    timesteps: torch.Tensor
    uniform_idx: Optional[torch.Tensor] = None
    occupied_u: Optional[torch.Tensor] = None


def draw_occupancy(n_cells: int, n_timesteps: int, warmup: bool,
                   generator: torch.Generator) -> OccupancyDraws:
    """``OccupancyDraws`` from ``generator`` (on its device): after warm-up
    a quarter of the cells uniformly and a quarter from the occupied ones."""
    dev = generator.device
    uniform_idx = occupied_u = None
    if warmup:
        n = n_cells
    else:
        m = n_cells // 4
        uniform_idx = torch.randint(0, n_cells, (m,), generator=generator,
                                    device=dev)
        occupied_u = torch.rand(m, generator=generator, device=dev)
        n = 2 * m
    return OccupancyDraws(
        cell_jitter=torch.rand(n, 3, generator=generator, device=dev),
        timesteps=torch.randint(0, n_timesteps, (n,), generator=generator,
                                device=dev),
        uniform_idx=uniform_idx, occupied_u=occupied_u)


def cell_positions(cell_idx: torch.Tensor, resolution: int,
                   aabb_min: torch.Tensor, aabb_max: torch.Tensor,
                   jitter: torch.Tensor) -> torch.Tensor:
    """Flat cell indices -> world positions, at ``jitter`` [N, 3] in [0, 1)
    inside the cell. Indices past G^3 address coarser cascade levels (level
    l covers the base box scaled by 2^l)."""
    g = resolution
    lvl = torch.div(cell_idx, g ** 3, rounding_mode="floor")
    cell = cell_idx % (g ** 3)
    k = cell % g
    j = torch.div(cell, g, rounding_mode="floor") % g
    i = torch.div(cell, g * g, rounding_mode="floor")
    coords = torch.stack([i, j, k], dim=-1).to(torch.float32) + jitter
    center = (aabb_min + aabb_max) * 0.5
    half = (aabb_max - aabb_min) * 0.5 \
        * torch.exp2(lvl.to(torch.float32))[:, None]
    return (center - half) + coords / g * (2.0 * half)


def _sample_occupied_cells(u: torch.Tensor, binaries_flat: torch.Tensor) -> torch.Tensor:
    """Cells drawn ~uniformly from the occupied set by inverse CDF of the
    uniforms ``u`` [m] (cell 0 when nothing is occupied)."""
    cdf = torch.cumsum(binaries_flat.to(torch.float32), dim=0)
    scaled = u * torch.clamp(cdf[-1], min=1.0)
    return torch.clamp(torch.searchsorted(cdf, scaled, right=True), 0,
                       cdf.shape[0] - 1)


def update_occupancy_grid(occs: torch.Tensor, occ_eval_fn: Callable,
                          draws: OccupancyDraws, resolution: int,
                          aabb_min: torch.Tensor, aabb_max: torch.Tensor,
                          occ_thre: float, ema_decay: float,
                          warmup: bool) -> torch.Tensor:
    """One EMA update of the grid: returns the new [L*G^3] state.

    ``occ_eval_fn(positions [M, 3], timesteps [M])`` gives the probes' occ
    values (density * render_step_size). A cell probed more than once takes
    its largest candidate, on any device; XLA's scatter in the JAX package
    keeps whichever duplicate it writes last.
    """
    n_cells = occs.shape[0]
    if warmup:
        idx = torch.arange(n_cells, device=occs.device)
    else:
        binaries = occupancy_binaries(occs, occ_thre).reshape(-1)
        idx = torch.cat([draws.uniform_idx.to(torch.int64),
                         _sample_occupied_cells(draws.occupied_u, binaries)])
    positions = cell_positions(idx, resolution, aabb_min, aabb_max,
                               draws.cell_jitter)
    occ_new = occ_eval_fn(positions, draws.timesteps)
    candidates = torch.maximum(occs[idx] * ema_decay, occ_new)
    return occs.scatter_reduce(0, idx, candidates, reduce="amax",
                               include_self=False)


def frustum_culling_grid(camera_frustums, resolution: int,
                         aabb_min: np.ndarray, aabb_max: np.ndarray,
                         min_cameras: int) -> np.ndarray:
    """[G, G, G] bool, True where a voxel corner point (linspace over the
    box, as the reference's sampler does) is inside at least ``min_cameras``
    training-camera view frustums (``data.cameras.Frustum``)."""
    g = resolution
    xs = np.linspace(aabb_min[0], aabb_max[0], g)
    ys = np.linspace(aabb_min[1], aabb_max[1], g)
    zs = np.linspace(aabb_min[2], aabb_max[2], g)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    points = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    count = np.zeros(points.shape[0], dtype=np.int32)
    for frustum in camera_frustums:
        count += frustum.contains_points(points).astype(np.int32)
    return (count >= min_cameras).reshape(g, g, g)
