"""Occupancy-grid ray marching with fixed shapes (port of
nersemble_tpu/ops/sampling.py).

Rays are intersected with the scene box, marched in ``n_candidates``
uniform steps (shifted by a per-ray jitter in training), candidates in
unoccupied cells are dropped, and the first ``S`` valid candidates per ray
are kept in [R, S] slots (mask marks valid slots). Global compaction then
picks the samples the field evaluates; the trainer sizes that budget with
``quantized_budget``. With a cone angle the steps grow with distance
(``cone_march_ts``), and the eval march may start each ray at its first
occupied coarse probe (``coarse_entry_steps``, the two-phase prefilter).
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


class RaySamples(NamedTuple):
    """Fixed-shape per-ray samples: all [R, S] (mask marks valid slots)."""

    t_starts: torch.Tensor
    t_ends: torch.Tensor
    mask: torch.Tensor

    def positions(self, origins, directions):
        """World-space midpoints [R, S, 3]."""
        mids = (self.t_starts + self.t_ends) * 0.5
        return origins[:, None, :] + directions[:, None, :] * mids[..., None]


def scatter_rows_back(x: torch.Tensor, sel: torch.Tensor,
                      n_total: int) -> torch.Tensor:
    """Rows ``x [budget, C]`` placed at rows ``sel`` of a zero [n_total, C]
    buffer (``sel`` is duplicate-free)."""
    out = torch.zeros(n_total, x.shape[1], dtype=x.dtype, device=x.device)
    out[sel] = x
    return out


def compact_samples(mask: torch.Tensor, budget: int,
                    n_sel: Optional[int] = None):
    """Pick ``budget`` valid (ray, slot) pairs, slot-major, with a stable
    sort on ~valid. Returns (sel [n_sel] flat slot-major indices, kept
    [R, S]); ``n_sel`` (default ``budget``, at most R * S) extends ``sel``
    past the budget with the next positions of the same order, none kept."""
    R, S = mask.shape
    mask_t = mask.t().reshape(-1)
    order = torch.argsort((~mask_t).to(torch.uint8), stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=mask.device)
    sel = order[:budget if n_sel is None else n_sel]
    kept = mask_t & (inv < budget)
    return sel, kept.reshape(S, R).t()


def monotone_ranks(counts: torch.Tensor, n_slots: int, n_sel: int):
    """The staircase of ``compact_samples_monotone`` from the per-ray valid
    counts ``counts`` [R] alone: (sel [n_sel] flat slot-major indices, C
    [S + 1] the valid samples before each slot, inv_order [R] each ray's
    place in the fill order). Sample (r, s) has rank ``C[s] +
    inv_order[r]`` and is kept iff that rank is below the budget."""
    R, S = counts.shape[0], n_slots
    dev = counts.device
    order = torch.argsort(-counts, stable=True)
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(R, device=dev)
    n_sorted = counts[order]
    slots = torch.arange(S, device=dev)
    c = (n_sorted[None, :] > slots[:, None]).sum(dim=1)  # [S] valid rays/slot
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    C = torch.cat([zero, torch.cumsum(c, 0)])  # [S+1]
    total = C[S]
    j = torch.arange(n_sel, device=dev)

    def staircase_positions(C_, rank):
        # slot of each rank and its position within the slot (C_ ascending)
        s = torch.clamp(torch.searchsorted(C_[1:], rank, right=True), max=S - 1)
        n_le = torch.searchsorted(C_[:-1], rank, right=True)
        base = torch.where(n_le > 0, C_[:-1][torch.clamp(n_le - 1, min=0)],
                           torch.zeros_like(rank))
        return s, rank - base

    sv, pv = staircase_positions(C, j)
    Ci = torch.cat([zero, torch.cumsum(R - c, 0)])
    si, qi = staircase_positions(Ci, j - total)
    pi = c[si] + qi
    s = torch.where(j < total, sv, si)
    p = torch.clamp(torch.where(j < total, pv, pi), 0, R - 1)
    return s * R + order[p], C, inv_order


def compact_samples_monotone(mask: torch.Tensor, budget: int,
                             n_sel: Optional[int] = None):
    """``compact_samples`` for per-ray-monotone masks (a valid slot prefix
    per ray): rank arithmetic over the "staircase" of rays sorted by fill
    count replaces the sort over R*S keys (``monotone_ranks``). Padding
    ranks past the valid count map to invalid positions, so ``sel`` stays
    duplicate-free. Returns (sel [n_sel], kept [R, S]), ``n_sel`` as in
    ``compact_samples``."""
    S = mask.shape[1]
    sel, C, inv_order = monotone_ranks(mask.sum(dim=1, dtype=torch.int64), S,
                                       budget if n_sel is None else n_sel)
    kept = mask & (C[None, :S] + inv_order[:, None] < budget)
    return sel, kept


def ray_aabb_intersect(origins, directions, aabb_min, aabb_max):
    """Slab test: [R, 3] rays x AABB -> (t_near [R], t_far [R]); misses give
    t_near > t_far."""
    tiny = torch.where(directions >= 0, 1e-12, -1e-12)
    inv = 1.0 / torch.where(directions.abs() < 1e-12, tiny, directions)
    t0 = (aabb_min[None, :] - origins) * inv
    t1 = (aabb_max[None, :] - origins) * inv
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    return t_near, t_far


def level_aabb(aabb_min, aabb_max, level: int):
    """Box of occupancy cascade ``level``: the base box scaled by 2^level."""
    center = (aabb_min + aabb_max) * 0.5
    half = (aabb_max - aabb_min) * (0.5 * (2.0 ** level))
    return center - half, center + half


def occupancy_lookup(binaries, positions, aabb_min, aabb_max):
    """Binary grid ([G,G,G] or cascade [L,G,G,G]) at [..., 3] world
    positions; the finest level containing a position decides."""
    if binaries.dim() == 3:
        binaries = binaries[None]
    occ = torch.zeros(positions.shape[:-1], dtype=torch.bool,
                      device=positions.device)
    g = binaries.shape[1:]
    for lvl in reversed(range(binaries.shape[0])):
        lo, hi = level_aabb(aabb_min, aabb_max, lvl)
        norm = (positions - lo) / (hi - lo)
        in_bounds = torch.ones_like(occ)
        flat = torch.zeros_like(occ, dtype=torch.int64)
        for axis in range(3):
            cell = torch.floor(norm[..., axis] * g[axis]).to(torch.int64)
            in_bounds &= (cell >= 0) & (cell < g[axis])
            flat = flat * g[axis] + cell.clamp(0, g[axis] - 1)
        occ = torch.where(in_bounds, binaries[lvl].reshape(-1)[flat], occ)
    return occ


def cone_march_ts(t_near: torch.Tensor, steps: torch.Tensor,
                  render_step_size: float, cone_angle: float) -> torch.Tensor:
    """Closed form of nerfacc's growing-step march ``t += max(t * cone,
    dt)`` at fractional step index ``steps`` ([R, N] or broadcastable):
    uniform steps up to ``k0 = ceil(max(dt / cone - t_near, 0) / dt)``, then
    geometric with ratio ``1 + cone`` (the JAX docstring derives it)."""
    dt, c = render_step_size, cone_angle
    k0 = torch.ceil(torch.clamp(dt / c - t_near, min=0.0) / dt)  # [R]
    t_base = t_near + k0 * dt
    linear = t_near[:, None] + steps * dt
    geometric = t_base[:, None] * torch.exp((steps - k0[:, None])
                                            * float(math.log1p(c)))
    return torch.where(steps <= k0[:, None], linear, geometric)


def _comb_ts(t_near, k, render_step_size: float, cone_angle: float):
    """t at step indices ``k`` [R, N]: uniform, or the cone's growing comb."""
    if cone_angle > 0.0:
        return cone_march_ts(t_near, k, render_step_size, cone_angle)
    return t_near[:, None] + k * render_step_size


def march_range(origins, directions, aabb_min, aabb_max, binaries,
                near_plane: float, far_plane: float):
    """Per-ray [t_near, t_far]: slab test against the coarsest cascade
    level's box, clipped to the near/far planes."""
    outer_min, outer_max = aabb_min, aabb_max
    if binaries is not None and binaries.dim() == 4 and binaries.shape[0] > 1:
        outer_min, outer_max = level_aabb(aabb_min, aabb_max,
                                          binaries.shape[0] - 1)
    t_near, t_far = ray_aabb_intersect(origins, directions, outer_min,
                                       outer_max)
    return torch.clamp(t_near, min=near_plane), torch.clamp(t_far, max=far_plane)


def dilate_binaries(binaries: torch.Tensor) -> torch.Tensor:
    """One-cell dilation (3x3x3 max-pool with edge replication) of a
    [G,G,G] or [L,G,G,G] binary grid."""
    squeeze = binaries.dim() == 3
    b = binaries[None] if squeeze else binaries
    for axis in (1, 2, 3):
        size = b.shape[axis]
        fwd = torch.cat([b.narrow(axis, 1, size - 1),
                         b.narrow(axis, size - 1, 1)], dim=axis)
        bwd = torch.cat([b.narrow(axis, 0, 1),
                         b.narrow(axis, 0, size - 1)], dim=axis)
        b = b | fwd | bwd
    return b[0] if squeeze else b


def occupied_world_aabb(binaries, aabb_min, aabb_max, expand_cells: float = 2.0):
    """World AABB of the occupied cells (union over cascade levels), each
    level's box grown by ``expand_cells`` of its cell width. Every sample
    the eval march can mark valid lies inside it, so a ray that misses it
    renders exact background. Returns (lo [3], hi [3], any_occ bool)."""
    if binaries.dim() == 3:
        binaries = binaries[None]
    big = 3.4e38
    dev = aabb_min.device
    lo_all = torch.full((3,), big, dtype=torch.float32, device=dev)
    hi_all = torch.full((3,), -big, dtype=torch.float32, device=dev)
    any_all = False
    for lvl in range(binaries.shape[0]):
        lo_l, hi_l = level_aabb(aabb_min, aabb_max, lvl)
        b = binaries[lvl]
        if not bool(b.any()):
            continue
        cell = (hi_l - lo_l) / torch.tensor(b.shape, dtype=torch.float32,
                                            device=dev)
        mins, maxs = [], []
        for ax in range(3):
            occ = b.any(dim=tuple(a for a in range(3) if a != ax))
            idx = torch.nonzero(occ)[:, 0]
            mins.append(idx.min())
            maxs.append(idx.max() + 1)
        mn = torch.stack(mins).to(torch.float32) - expand_cells
        mx = torch.stack(maxs).to(torch.float32) + expand_cells
        lo_all = torch.minimum(lo_all, lo_l + mn * cell)
        hi_all = torch.maximum(hi_all, lo_l + mx * cell)
        any_all = True
    return lo_all, hi_all, any_all


def coarse_entry_steps(origins, directions, t_near, t_far, dilated_binaries,
                       aabb_min, aabb_max, render_step_size: float,
                       n_candidates: int, stride: int,
                       cone_angle: float = 0.0) -> torch.Tensor:
    """Per-ray step index (float) at which the fine march starts: the
    DILATED grid is probed every ``stride`` candidate steps over the full
    comb, and the start is one stride before the first occupied probe (0
    at the earliest). Rays with no hit start at ``n_candidates``, past
    t_far, so their fine window is empty."""
    n_coarse = -(-n_candidates // stride)
    k = (torch.arange(n_coarse, dtype=origins.dtype, device=origins.device)
         * stride)[None, :]
    ts = _comb_ts(t_near, k + 0.5 * stride, render_step_size, cone_angle)
    pos = origins[:, None, :] + directions[:, None, :] * ts[..., None]
    occ = occupancy_lookup(dilated_binaries, pos, aabb_min, aabb_max)
    occ = occ & (ts < t_far[:, None])
    first = torch.argmax(occ.to(torch.uint8), dim=-1)  # first True (0: none)
    k0 = (torch.clamp(first - 1, min=0) * stride).to(origins.dtype)
    return torch.where(occ.any(dim=-1), k0,
                       torch.full_like(k0, float(n_candidates)))


def box_span(scene_box, grid_levels: int = 1) -> float:
    """World units a march may have to cover: the diagonal of the scene
    box (of the coarsest cascade level's box)."""
    box = np.asarray(scene_box, np.float32)
    return float(np.linalg.norm(box[1] - box[0])) * (2.0 ** (grid_levels - 1))


def candidates_to_span(span: float, render_step_size: float,
                       cone_angle: float = 0.0, near_plane: float = 0.0) -> int:
    """Candidate steps that cover ``span`` world units from the entry
    point with the least growth: span / step, or with a cone angle the
    steps ``max(t * cone_angle, step)`` counted on the host."""
    if cone_angle <= 0:
        return int(np.ceil(span / render_step_size))
    t = max(near_plane, render_step_size)
    end, n = t + span, 0
    while t < end:
        t += max(t * cone_angle, render_step_size)
        n += 1
    return n


def spanning_comb(scene_box, grid_levels: int, render_step_size: float,
                  cone_angle: float = 0.0, near_plane: float = 0.0) -> int:
    """The candidate comb that spans the (coarsest cascade level's) scene
    box from the entry point, rounded up to 128: the auto-sized candidate
    count, and the samples a ray of a dense march."""
    n = candidates_to_span(box_span(scene_box, grid_levels), render_step_size,
                           cone_angle, near_plane)
    return -(-n // 128) * 128


def dense_budget(n_valid: int, n_slots: int) -> int:
    """The rows a dense march's step evaluates: its ``n_valid`` valid
    samples rounded up to a multiple of 256 (at least 256, at most the
    ``n_slots`` slots)."""
    return min(max(-(-int(n_valid) // 256) * 256, 256), n_slots)


def quantized_budget(measured_samples: float, n_rays: int, n_slots: int,
                     headroom: float = 1.15,
                     current: Optional[int] = None) -> int:
    """Next train-step compaction budget from a measured valid-sample count:
    ``measured * headroom`` rounded up to a quantum of R*S/128, with
    hysteresis against ``current`` (grow at once, shrink only by a whole
    quantum). The reasoning behind the numbers is in the JAX docstring."""
    total = n_rays * n_slots
    quantum = max(total // 128, 128)
    q = -(-int(measured_samples * headroom) // quantum) * quantum
    q = min(max(q, quantum), total)
    if current is not None:
        if q > current or q <= current - quantum:
            return q
        return current
    return q


def march_rays(origins: torch.Tensor,
               directions: torch.Tensor,
               aabb_min: torch.Tensor,
               aabb_max: torch.Tensor,
               render_step_size: float,
               n_candidates: int,
               max_samples_per_ray: int,
               binaries: Optional[torch.Tensor] = None,
               near_plane: float = 0.0,
               far_plane: float = 1e10,
               jitter: Optional[torch.Tensor] = None,
               cone_angle: float = 0.0,
               start_steps: Optional[torch.Tensor] = None,
               occupancy_stride: int = 1):
    """Rays -> compacted RaySamples + diagnostics.

    ``jitter``: optional [R] uniforms in [0, 1) shifting each ray's sample
    comb (training-time stratification); None starts at the near point.
    ``cone_angle > 0`` grows the step with distance (``cone_march_ts``).
    ``start_steps``: optional [R] step offsets added to the comb (the
    coarse-prefilter entry points of ``coarse_entry_steps``): the window
    covers steps [start, start + n_candidates).
    ``occupancy_stride > 1`` probes ``binaries`` once per group of that many
    candidates, at the group's centre, and lets it vouch for the group; it
    requires a dilated grid and (stride/2) * step <= one cell (see the JAX
    docstring). The first ``S`` valid candidates per ray are selected with
    ``topk`` on the candidate index; slots past a ray's valid count hold
    arbitrary candidates, so compare them under the mask.
    """
    t_near, t_far = march_range(origins, directions, aabb_min, aabb_max,
                                binaries, near_plane, far_plane)
    dtype, dev = origins.dtype, origins.device
    steps = torch.arange(n_candidates, dtype=dtype, device=dev)
    if jitter is None:
        jitter = torch.zeros_like(t_near)
    offset = jitter if start_steps is None else jitter + start_steps
    k = steps[None, :] + offset[:, None]
    t0 = _comb_ts(t_near, k, render_step_size, cone_angle)
    if cone_angle > 0.0:
        t1 = _comb_ts(t_near, k + 1.0, render_step_size, cone_angle)
    else:
        t1 = t0 + render_step_size
    valid = (t0 + t1) * 0.5 < t_far[:, None]

    if binaries is not None:
        if occupancy_stride > 1:
            n_probe = -(-n_candidates // occupancy_stride)
            kp = (torch.arange(n_probe, dtype=dtype, device=dev) * occupancy_stride
                  + 0.5 * occupancy_stride)[None, :] + offset[:, None]
            tp = _comb_ts(t_near, kp, render_step_size, cone_angle)
            posp = origins[:, None, :] + directions[:, None, :] * tp[..., None]
            occ_p = occupancy_lookup(binaries, posp, aabb_min, aabb_max)
            occupied = occ_p.repeat_interleave(occupancy_stride,
                                               dim=1)[:, :n_candidates]
        else:
            mids = (t0 + t1) * 0.5
            pos = origins[:, None, :] + directions[:, None, :] * mids[..., None]
            occupied = occupancy_lookup(binaries, pos, aabb_min, aabb_max)
        valid = valid & occupied

    big = n_candidates + 1
    key = torch.where(valid, torch.arange(n_candidates, device=dev)[None, :],
                      torch.full_like(valid, big, dtype=torch.int64))
    vals, order = torch.topk(key, max_samples_per_ray, dim=1, largest=False,
                             sorted=True)
    k_sel = order.to(dtype) + offset[:, None]
    t_starts = _comb_ts(t_near, k_sel, render_step_size, cone_angle)
    if cone_angle > 0.0:
        t_ends = _comb_ts(t_near, k_sel + 1.0, render_step_size, cone_angle)
    else:
        t_ends = t_starts + render_step_size
    mask = vals < big

    n_valid_total = valid.sum(dim=-1)
    info = {
        "n_samples_per_ray": mask.sum(dim=-1),
        "n_dropped_per_ray": torch.clamp(n_valid_total - max_samples_per_ray,
                                         min=0),
        "t_near": t_near,
        "t_far": t_far,
    }
    return RaySamples(t_starts=t_starts, t_ends=t_ends, mask=mask), info
