"""Whole-image rendering: the render half of the JAX trainer (port of
``NeRSembleTrainer.render_chunk``, ``render_image`` and ``_render_hit_mask``,
nersemble_tpu/engine/trainer.py:331-398, 645-780).

``Renderer`` holds the model, its parameters and the occupancy state. A
frame's rays are packed (rays that provably miss every occupied cell are
composited as background without evaluating anything), cut into chunks,
rendered with ``render_rays(train=False)`` and scattered back. The xz-quad
gather operand is built once per parameter state and reused across chunks
and frames, and so is the probed budget of ``budget="auto"`` per grid
state.

Over several ranks (``mesh``) every rank holds the frame's rays and renders
its slice of each chunk (the chunk padded to a multiple of the ranks); the
chunk's rows are all-gathered and its counts all-reduced, so every rank
assembles the same frame and makes the same budget decisions.

The frame's rays reach the device by non-blocking copies from page-locked
memory, and the chunk loop reads nothing back: the host waits on the device
only for the packed hit indices, the auto budget's probe (once per grid
state) and drop counts (once per frame, one stacked read), and the final
copy of the frame.
"""

from typing import Dict, Optional

import numpy as np
import torch

from nersemble_tpu_torch.models.nersemble import NeRSembleModel
from nersemble_tpu_torch.ops.sampling import occupied_world_aabb, ray_aabb_intersect
from nersemble_tpu_torch.parallel.mesh import pad_to_multiple
from nersemble_tpu_torch.utils.device import to_device
from nersemble_tpu_torch.utils.params import ParamTree
from nersemble_tpu_torch.utils.windows import sched_values

RAY_KEYS = ("origins", "directions", "timesteps")
AUTO_BUDGET_QUANTUM = 8192


def quantize_auto_budget(n_valid: float, chunk: int, samples_per_ray: int) -> int:
    """The auto render budget for a chunk with ``n_valid`` valid samples:
    x1.5 headroom, rounded up to the quantum, within [quantum, chunk * S]
    (JAX ``render_image``'s ``quantize``)."""
    b = int(n_valid * 1.5)
    q = AUTO_BUDGET_QUANTUM
    return min(max(-(-b // q) * q, q), chunk * samples_per_ray)


class Renderer:
    """Model + parameters + occupancy grid state (+ optional frustum mask)."""

    def __init__(self, model: NeRSembleModel, params: ParamTree,
                 grid_occs: torch.Tensor,
                 grid_mask: Optional[torch.Tensor] = None, mesh=None):
        self.model = model
        self.mesh = mesh
        self.params = params
        self.grid_occs = grid_occs
        self.grid_mask = grid_mask
        self.device = grid_occs.device
        self._fparams = None   # (params, table version, prepared field)
        self._packing = None   # (grid_occs, grid_mask, lo, hi, any_occ)
        self._auto = None      # (grid_occs, grid_mask, probed budget)

    @property
    def auto_budget(self) -> Optional[int]:
        """The budget ``budget="auto"`` probed on the current grid state
        (None until the next auto render probes it)."""
        cache = self._auto
        if (cache is None or cache[0] is not self.grid_occs
                or cache[1] is not self.grid_mask):
            return None
        return cache[2]

    @auto_budget.setter
    def auto_budget(self, value: Optional[int]) -> None:
        self._auto = (self.grid_occs, self.grid_mask, value)

    def fparams(self) -> Dict:
        """The prepared field (quad table) for the current parameters,
        rebuilt when the parameter object or its table changes."""
        table = self.params.field.table
        key = (self.params, table._version)
        if self._fparams is None or self._fparams[:2] != key:
            self._fparams = (*key, self.model.prepare_field(self.params))
        return self._fparams[2]

    def render_chunk(self, batch: Dict, sched: Dict,
                     budget: Optional[int] = None) -> Dict:
        """One chunk -> packed [R, 8] (rgb 3 | depth 1 | acc 1 | deformation
        3) plus the valid-sample and budget-drop counts. With a mesh each
        rank renders its slice of the chunk (R divides over the ranks) and
        gets the whole chunk's results."""
        mesh = self.mesh
        if mesh is not None:
            rows = mesh.rows(batch["origins"].shape[0])
            batch = {key: arr[rows] for key, arr in batch.items()}
        binaries = self.model.binaries(self.grid_occs, self.grid_mask)
        out = self.model.render_rays(self.params, batch, binaries, sched,
                                     train=False, budget=budget,
                                     fparams=self.fparams(), mesh=mesh)
        cols = [out["rgb"], out["depth"], out["accumulation"],
                out.get("deformation", torch.zeros_like(out["rgb"]))]
        dropped = out["num_budget_dropped"]
        if not isinstance(dropped, torch.Tensor):  # every slot evaluated
            dropped = torch.zeros((), dtype=torch.int64, device=self.device)
        packed, n_valid = torch.cat(cols, dim=1), out["num_samples_per_ray"].sum()
        if mesh is not None:
            packed = mesh.all_gather_rows(packed)
            n_valid, dropped = mesh.all_reduce_sum(torch.stack([n_valid, dropped]))
        return {"_packed": packed, "_n_valid": n_valid,
                "_n_budget_dropped": dropped}

    def render_hit_mask(self, origins: torch.Tensor,
                        directions: torch.Tensor) -> torch.Tensor:
        """bool [n]: which rays can hit an occupied cell (slab test against
        the expanded occupied-cell AABB, cached per grid state)."""
        cache = self._packing
        if (cache is None or cache[0] is not self.grid_occs
                or cache[1] is not self.grid_mask):
            lo, hi, any_occ = occupied_world_aabb(
                self.model.binaries(self.grid_occs, self.grid_mask),
                self.model.aabb_min, self.model.aabb_max)
            cache = self._packing = (self.grid_occs, self.grid_mask, lo, hi,
                                     any_occ)
        _, _, lo, hi, any_occ = cache
        if not any_occ:
            return torch.zeros(origins.shape[0], dtype=torch.bool,
                               device=origins.device)
        cfg = self.model.config
        t_near, t_far = ray_aabb_intersect(origins, directions, lo, hi)
        return torch.clamp(t_near, min=cfg.near_plane) \
            <= torch.clamp(t_far, max=cfg.far_plane)

    @torch.no_grad()
    def render_image(self, image_rays: Dict, step: int,
                     chunk: int = 1024,
                     budget: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Render a frame: ``image_rays`` holds ``height``, ``width`` and
        per-pixel ``origins``, ``directions``, ``timesteps`` (numpy or
        tensors). ``budget``: None (R * S * fraction per chunk), a fixed
        int, or ``"auto"``: the first chunk on a grid state renders with
        None as a probe, its valid-sample count sets ``auto_budget``
        (``quantize_auto_budget``) for every later chunk, and every chunk
        that dropped samples under it is rendered again with None after
        all chunks were issued, growing ``auto_budget`` to cover it.
        Returns [H, W, C] numpy arrays."""
        if not (budget is None or budget == "auto" or isinstance(budget, int)):
            raise ValueError(f"budget={budget!r}: None, an int or 'auto'")
        cfg = self.model.config
        if self.mesh is not None:
            chunk = pad_to_multiple(chunk, self.mesh.size)
        H, W = image_rays["height"], image_rays["width"]
        n = H * W
        rays = {key: to_device(image_rays[key], self.device) for key in RAY_KEYS}
        pack_idx = None
        if cfg.sampling.eval_ray_packing and not cfg.disable_occupancy_grid:
            hit = self.render_hit_mask(rays["origins"], rays["directions"])
            pack_idx = torch.nonzero(hit)[:, 0]
            rays = {key: arr[pack_idx] for key, arr in rays.items()}
        n_render = n if pack_idx is None else int(pack_idx.numel())
        sched = sched_values(cfg, step)
        S = cfg.sampling.max_samples_per_ray
        if cfg.sampling.eval_max_samples_per_ray > 0:
            S = min(S, cfg.sampling.eval_max_samples_per_ray)

        results = []  # [lo, hi, out, budget used, batch]
        for lo in range(0, n_render, chunk):
            hi = min(lo + chunk, n_render)
            batch = {}
            for key, arr in rays.items():
                arr = arr[lo:hi]
                if hi - lo < chunk:
                    # pad with the last ray: the per-chunk budget is a
                    # function of the chunk size, as in the JAX renderer
                    arr = torch.cat([arr, arr[-1:].expand(chunk - (hi - lo),
                                                          *arr.shape[1:])])
                batch[key] = arr
            use = self.auto_budget if budget == "auto" else budget
            out = self.render_chunk(batch, sched, use)
            if budget == "auto" and use is None:  # the probe chunk
                self.auto_budget = quantize_auto_budget(
                    float(out["_n_valid"]), chunk, S)
            results.append([lo, hi, out, use, batch])

        if budget == "auto":
            # overflow safety net: the drop counts are read once, after
            # every chunk was issued, so the queue stays full
            budgeted = [rec for rec in results if rec[3] is not None]
            dropped = torch.stack([rec[2]["_n_budget_dropped"]
                                   for rec in budgeted]).tolist() if budgeted else []
            redo = [rec for rec, d in zip(budgeted, dropped) if d > 0]
            for rec in redo:
                rec[2] = self.render_chunk(rec[4], sched, None)
            if redo:
                valid = torch.stack([rec[2]["_n_valid"] for rec in redo]).tolist()
                self.auto_budget = max(
                    [self.auto_budget or 0]
                    + [quantize_auto_budget(v, chunk, S) for v in valid])

        parts = [out["_packed"][:hi - lo] for lo, hi, out, _, _ in results]
        packed = torch.zeros(n, 8, dtype=torch.float32, device=self.device)
        if pack_idx is None:
            if parts:
                packed = torch.cat(parts)
        else:
            # skipped rays: zero weights -> rgb = background, the rest 0
            packed[:, 0:3] = self.model.background
            if parts:
                packed[pack_idx] = torch.cat(parts)
        packed = packed.cpu().numpy()
        image = {"rgb": packed[:, 0:3], "depth": packed[:, 3:4],
                 "accumulation": packed[:, 4:5]}
        if cfg.use_deformation_field:
            image["deformation"] = packed[:, 5:8]
        return {key: val.reshape(H, W, -1) for key, val in image.items()}
