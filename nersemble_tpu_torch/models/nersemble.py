"""The NeRSemble dynamic radiance-field model (port of
nersemble_tpu/models/nersemble.py).

Occupancy-grid ray marching -> per-timestep latent lookup -> SE(3) warp
into canonical space -> hash-ensemble field -> alpha compositing ->
supervision losses; the occupancy grid's EMA update goes through the same
field. The model object holds the static configuration; parameters are a
``ParamTree`` (``init_params`` or ``engine.checkpoints.params_from_numpy``)
and the grid state a tensor, both passed in, like the JAX package's
functional style.

World/normalized composition quirk kept from the reference: the warp is
computed on AABB-normalized positions and its offset is added to the WORLD
position.

Over several ranks (``mesh``, a ``parallel.mesh.DataMesh``) each rank holds
its own slice of the ray batch and the computation stays the global one
that GSPMD makes of the JAX step: the compaction ranks the samples of every
rank's rays (``_sharded_compaction``), each rank evaluates an equal share
of the global selection, the evaluated rows reach the ranks of their rays by
an all-gather (a reduce-scatter in the backward), and the loss means divide
by the global counts.
"""

import copy
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nersemble_tpu_torch.config import ModelConfig
from nersemble_tpu_torch.models.deformation import (
    deformation_offsets,
    init_deformation_field,
)
from nersemble_tpu_torch.models.field import (
    build_levels,
    field_density,
    field_rgb,
    init_field,
    prepare_field,
)
from nersemble_tpu_torch.ops import losses as L
from nersemble_tpu_torch.ops import time_code
from nersemble_tpu_torch.ops.distortion import distortion_loss
from nersemble_tpu_torch.ops.occupancy import (
    OccupancyDraws,
    draw_occupancy,
    occupancy_binaries,
    update_occupancy_grid,
)
from nersemble_tpu_torch.ops.rendering import (
    exclusive_cumsum,
    render_accumulation,
    render_depth_expected,
    render_expected_value,
    render_rgb,
    render_weights,
)
from nersemble_tpu_torch.ops.sampling import (
    box_span,
    candidates_to_span,
    coarse_entry_steps,
    compact_samples,
    dense_budget,
    dilate_binaries,
    march_range,
    march_rays,
    monotone_ranks,
    scatter_rows_back,
    spanning_comb,
)
from nersemble_tpu_torch.parallel.mesh import DataMesh, pad_to_multiple
from nersemble_tpu_torch.utils import spans
from nersemble_tpu_torch.utils.device import resolve_device
from nersemble_tpu_torch.utils.params import ParamTree, normal

_BACKGROUNDS = {"white": (1.0, 1.0, 1.0), "black": (0.0, 0.0, 0.0)}


def _gather_rows(weight: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``weight[index]`` with a backward that sums each row's gradient in a
    fixed order, so that a run repeats bit for bit. On the card the
    time-code kernel (``ops/time_code.py``), which sums in an order fixed
    by the shapes alone (the backward of ``F.embedding`` there is not: two
    runs differed in the time embeddings). On the CPU the indexing backward
    adds rows with atomics across threads (ROADMAP C12); there
    ``F.embedding``, whose backward walks each row's indices in order."""
    return time_code.gather_rows(weight, index) if weight.is_cuda \
        else F.embedding(index, weight)


def _field_chunk(body, inputs: tuple):
    spans.tally("field_chunks")
    with spans.span("render:chunk"):
        return body(*inputs)


class NeRSembleModel:
    """Static configuration and the render computation over a ParamTree."""

    def __init__(self, config: ModelConfig, device="cuda"):
        # own copy: auto-sizing the candidate count below edits it
        self.config = config = copy.deepcopy(config)
        self.device = resolve_device(device)
        self.levels = build_levels(config)
        box = np.asarray(config.scene_box, np.float32)
        self.aabb_min = torch.from_numpy(box[0]).to(self.device)
        self.aabb_max = torch.from_numpy(box[1]).to(self.device)
        self.background = torch.tensor(_BACKGROUNDS[config.background_color],
                                       dtype=torch.float32, device=self.device)
        self.compute_dtype = getattr(torch, config.compute_dtype)
        # ("rows" or "cols", mesh) under the ZeRO-3 or the feature-sharded
        # table (set by the trainer; models/field.prepare_field)
        self.table_layout = None
        if config.use_hash_ensemble and \
                config.latent_dim_time != config.hash_ensemble.n_hash_encodings:
            raise ValueError("latent_dim_time must equal n_hash_encodings")
        # the candidate comb must span the (coarsest-level) scene box
        diag = box_span(config.scene_box, config.grid_levels)
        needed = self._candidates_to_span(diag)
        if config.sampling.max_candidates_per_ray == -1:
            config.sampling.max_candidates_per_ray = spanning_comb(
                config.scene_box, config.grid_levels, config.render_step_size,
                config.cone_angle, config.near_plane)
        elif config.sampling.max_candidates_per_ray < needed:
            print(f"[nersemble-torch] WARNING: max_candidates_per_ray="
                  f"{config.sampling.max_candidates_per_ray} candidates cannot "
                  f"span the {diag:.2f}-unit scene-box diagonal: rays will "
                  f"stop mid-scene. Use -1 to auto-size (= {needed}).")

    def _candidates_to_span(self, span: float) -> int:
        """Candidate steps that cover ``span`` world units from the entry
        point (``ops.sampling.candidates_to_span`` at this model's step,
        cone angle and near plane)."""
        cfg = self.config
        return candidates_to_span(span, cfg.render_step_size, cfg.cone_angle,
                                  cfg.near_plane)

    def evaluates_valid_samples(self, budget: int, n_slots: int) -> bool:
        """Whether a training step at ``budget`` of its ``n_slots`` slots
        evaluates just its valid samples, as many as the step has
        (``_dense_budget``): a dense march (no occupancy grid, most slots
        empty) asked for every slot. The adaptive budget then has nothing
        to adapt."""
        return self.config.disable_occupancy_grid and budget >= n_slots

    def _dense_budget(self, mask: torch.Tensor, mesh) -> int:
        """The rows a dense march's training step evaluates: its valid
        samples over every rank, read on the host (the span
        ``render:size``) and rounded up to 256 rows; the compaction then
        keeps every one."""
        with spans.span("render:size"):
            n_valid = spans.host_value(mesh.all_reduce_sum(mask.sum()))
        return dense_budget(n_valid, mask.numel() * mesh.size)

    # -- parameters ----------------------------------------------------------

    def init_params(self, generator: torch.Generator, device=None) -> ParamTree:
        """Random parameters drawn from ``generator`` (on its device), moved
        to ``device`` (default: the model's)."""
        cfg = self.config
        tree = {"field": init_field(generator, cfg, self.levels)}
        if cfg.use_deformation_field:
            tree["deformation"] = init_deformation_field(
                generator, cfg.deformation_field)
        if cfg.use_deformation_field or cfg.use_hash_ensemble:
            tree["time_embedding"] = normal(
                (cfg.n_timesteps, cfg.latent_dim_time),
                0.01 / math.sqrt(cfg.latent_dim_time), generator)
            if cfg.use_separate_deformation_time_embedding \
                    and cfg.use_deformation_field:
                d_dim = cfg.deformation_field.warp_code_dim
                tree["time_embedding_deformation"] = normal(
                    (cfg.n_timesteps, d_dim), 0.01 / math.sqrt(d_dim), generator)
        return ParamTree(tree).to(device or self.device)

    def binaries(self, grid_occs: torch.Tensor,
                 frustum_grid: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        g, levels = cfg.grid_resolution, cfg.grid_levels
        shape = (g, g, g) if levels == 1 else (levels, g, g, g)
        if cfg.disable_occupancy_grid:
            b = torch.ones(shape, dtype=torch.bool, device=grid_occs.device)
            if frustum_grid is not None:
                # the frustum grid lies on the base level's box
                if levels == 1:
                    b = b & frustum_grid
                else:
                    b[0] = frustum_grid
            return b
        return occupancy_binaries(grid_occs, cfg.occ_thre,
                                  frustum_grid).reshape(shape)

    def prepare_field(self, params: ParamTree) -> Dict:
        return prepare_field(params.field, self.config, self.levels,
                             self.table_layout)

    # -- per-sample evaluation -----------------------------------------------

    def _time_codes(self, params, timesteps):
        tc = tc_def = None
        if "time_embedding" in params:
            tc = spans.backward_span("bwd:time_code", _gather_rows,
                                     params.time_embedding, timesteps)
            tc_def = spans.backward_span("bwd:time_code", _gather_rows,
                                         params.time_embedding_deformation, timesteps) \
                if "time_embedding_deformation" in params else tc
        return tc, tc_def

    def _chunked_samples(self, body, inputs: tuple, n: int):
        """``body(*inputs)`` over the leading sample axis in equal,
        256-aligned pieces of at most ``max_n_samples_per_batch`` rows,
        bounding the [piece, 2L, 4W] gather buffers. Each piece is a field
        chunk: the span ``render:chunk``, counted in ``field_chunks``."""
        chunk = self.config.max_n_samples_per_batch
        if chunk == -1 or n <= chunk:
            return _field_chunk(body, inputs)
        k = -(-n // chunk)
        chunk = -(-(-(-n // k)) // 256) * 256
        outs = [_field_chunk(body, tuple(a[lo:lo + chunk] for a in inputs))
                for lo in range(0, n, chunk)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)

    def _warp_positions(self, params, positions, tc_def, sched):
        """World positions + the deformation offset (and the offset)."""
        cfg = self.config
        if not cfg.use_deformation_field:
            return positions, None
        norm = (positions - self.aabb_min) / (self.aabb_max - self.aabb_min)
        offsets = deformation_offsets(
            params.deformation, norm, tc_def, cfg.deformation_field,
            window_param=sched.get("window_deform"),
            compute_dtype=self.compute_dtype, use_fused_mlp=cfg.use_fused_mlp)
        return positions + offsets, offsets

    def _density(self, params, fparams, pos, ts, sched):
        tc, tc_def = self._time_codes(params, ts)
        pos, _ = self._warp_positions(params, pos, tc_def, sched)
        density, _ = field_density(fparams, pos, tc, self.config, self.levels,
                                   self.aabb_min, self.aabb_max,
                                   window_hash=sched.get("window_hash"),
                                   compute_dtype=self.compute_dtype)
        return density

    def _density_rgb(self, params, fparams, pos, ts, dirs, cams, sched,
                     train):
        tc, tc_def = self._time_codes(params, ts)
        pos, offsets = self._warp_positions(params, pos, tc_def, sched)
        density, geo = field_density(fparams, pos, tc, self.config, self.levels,
                                     self.aabb_min, self.aabb_max,
                                     window_hash=sched.get("window_hash"),
                                     compute_dtype=self.compute_dtype)
        rgb = field_rgb(fparams, dirs, geo, self.config, camera_indices=cams,
                        train=train, compute_dtype=self.compute_dtype)
        if offsets is None:
            offsets = torch.zeros_like(pos)
        return density, rgb, offsets

    def _probe_termination(self, params, fparams, samples, ray_pack,
                           budget: int, sched: Dict, mesh) -> torch.Tensor:
        """Sigma-probed early termination, the fixed-shape analogue of
        nerfacc's eval transmittance stop: probe density at every ps-th
        slot (its own budget = budget / ps), accumulate coarse
        transmittance, and keep samples only up to one coarse group past
        the point where T falls below the threshold. Returns keep [R, S]."""
        scfg = self.config.sampling
        ps = scfg.eval_termination_probe_stride
        R, S = samples.mask.shape
        Sc = S // ps
        sub_mask = samples.mask[:, :Sc * ps:ps]
        sub_t = ((samples.t_starts + samples.t_ends) * 0.5)[:, :Sc * ps:ps]
        deltas = (samples.t_ends - samples.t_starts) * samples.mask
        delta_c = deltas[:, :Sc * ps].reshape(R, Sc, ps).sum(-1)
        bc = min(-(-max(budget // ps, 128) // 128) * 128, R * mesh.size * Sc)

        def probe(picked, tmid):
            pos = picked[:, 0:3] + picked[:, 3:6] * tmid[:, None]
            return self._chunked_samples(
                lambda p, t: self._density(params, fparams, p, t, sched),
                (pos, picked[:, 6].to(torch.int64)), pos.shape[0])[:, None]

        # a strided view of the prefix mask is still per-ray monotone
        sel_c, kept_c = self._sharded_compaction(sub_mask, bc, True, mesh)
        sig_back = self._evaluate_selected(probe, sel_c, bc, ray_pack, sub_t,
                                           mesh)[..., 0]
        sigma_c = sig_back * kept_c
        trans_c = torch.exp(-exclusive_cumsum(sigma_c * delta_c, dim=-1))
        alive = trans_c >= scfg.eval_early_stop_trans
        alive = alive | torch.cat([torch.ones_like(alive[:, :1]),
                                   alive[:, :-1]], dim=1)
        keep = alive.repeat_interleave(ps, dim=1)
        if S > Sc * ps:
            keep = torch.cat([keep, alive[:, -1:].expand(R, S - Sc * ps)], dim=1)
        return keep

    def _sharded_compaction(self, mask, budget: int, monotone: bool, mesh):
        """The compaction of the whole batch from this rank's rows: (sel
        [budget padded to a multiple of the ranks] slot-major indices over
        the global rays, kept [R, S] for this rank's rays). The monotone
        staircase needs only every ray's valid count (all-gathered); the
        sorted compaction gathers the masks."""
        R, S = mask.shape
        rows = mesh.rows(R * mesh.size)
        n_sel = pad_to_multiple(budget, mesh.size)
        if monotone:
            counts = mesh.all_gather_rows(mask.sum(dim=1, dtype=torch.int64))
            sel, C, inv_order = monotone_ranks(counts, S, n_sel)
            return sel, mask & (C[None, :S] + inv_order[rows, None] < budget)
        masks = mesh.all_gather_rows(mask.to(torch.uint8)).to(torch.bool)
        sel, kept = compact_samples(masks, budget, n_sel)
        return sel, kept[rows]

    def _evaluate_selected(self, fn, sel, budget: int, ray_pack, tmid, mesh):
        """``fn(picked ray_pack rows, tmid) -> [m, C]`` over this rank's
        equal share of the global selection ``sel`` (the rays and slot
        midpoints of every rank all-gathered), the rows past ``budget``
        zeroed, then all rows all-gathered and scattered into this rank's
        [R, S, C] slots. Differentiable: the backward of the gather
        reduce-scatters each row's gradient to the rank that evaluated it."""
        R, S = tmid.shape
        Rg, P = R * mesh.size, ray_pack.shape[1]
        share = mesh.rows(sel.shape[0])
        mine = sel[share]
        table = mesh.all_gather_rows(torch.cat([ray_pack, tmid], dim=1))
        ray, slot = mine % Rg, mine // Rg
        out = fn(table[ray, :P], table[ray, P + slot])
        if sel.shape[0] > budget:  # padding to a multiple of the ranks
            j = torch.arange(share.start, share.stop, device=out.device)
            out = torch.where((j < budget)[:, None], out, torch.zeros_like(out))
        rows = mesh.all_gather_rows_grad(out)
        back = scatter_rows_back(rows, sel, Rg * S).reshape(S, Rg, -1)
        return back[:, mesh.rows(Rg)].transpose(0, 1)

    def _evaluate_samples(self, params, fparams, samples, ray_pack,
                          budget: int, mask_monotone: bool, sched: Dict,
                          train: bool, mesh):
        """Field evaluation of the [R, S] samples: the ``budget`` picked by
        global slot-major compaction when it is below R * S (results
        scattered back to their slots), else every slot. ``ray_pack``
        column 7, when present, holds the camera indices (the appearance
        embedding's, training only). Returns (samples with the kept mask,
        sigmas [R, S], rgbs [R, S, 3], normalized offsets [R, S, 3],
        budget-dropped count)."""
        R, S = samples.mask.shape
        with_cams = ray_pack.shape[1] > 7

        def body(pos, ts, dirs, *cams):
            return self._density_rgb(params, fparams, pos, ts, dirs,
                                     cams[0] if cams else None, sched, train)

        if budget >= R * S * mesh.size:
            positions = samples.positions(ray_pack[:, 0:3], ray_pack[:, 3:6])
            per_ray = ray_pack[:, 6:].to(torch.int64)[:, None].expand(
                R, S, ray_pack.shape[1] - 6).reshape(R * S, -1)
            flat_dirs = ray_pack[:, None, 3:6].expand(R, S, 3)
            inputs = (positions.reshape(R * S, 3), per_ray[:, 0],
                      flat_dirs.reshape(R * S, 3))
            if with_cams:
                inputs += (per_ray[:, 1],)
            density, rgbs, offsets = self._chunked_samples(body, inputs, R * S)
            return (samples, density.reshape(R, S), rgbs.reshape(R, S, 3),
                    offsets.reshape(R, S, 3), 0)

        sel, kept = self._sharded_compaction(samples.mask, budget, mask_monotone,
                                             mesh)
        n_dropped = samples.mask.sum() - kept.sum()  # this rank's share
        samples = samples._replace(mask=kept)

        def evaluate(picked, tmid):
            inputs = (picked[:, 0:3] + picked[:, 3:6] * tmid[:, None],
                      picked[:, 6].to(torch.int64), picked[:, 3:6])
            if with_cams:
                inputs += (picked[:, 7].to(torch.int64),)
            density, rgbs, offsets = self._chunked_samples(body, inputs,
                                                           picked.shape[0])
            return torch.cat([density[:, None], rgbs, offsets], 1)

        back = self._evaluate_selected(evaluate, sel, budget, ray_pack,
                                       (samples.t_starts + samples.t_ends) * 0.5,
                                       mesh)
        return (samples, back[..., 0] * kept, back[..., 1:4], back[..., 4:7],
                n_dropped)

    # -- rendering -----------------------------------------------------------

    def render_rays(self, params: ParamTree, rays: Dict, binaries, sched: Dict,
                    train: bool = False, budget: Optional[int] = None,
                    fparams: Optional[Dict] = None,
                    jitter: Optional[torch.Tensor] = None,
                    mesh=None) -> Dict:
        """Render a ray batch: origins [R,3], directions [R,3], optional
        integer timesteps [R]. ``budget`` overrides the compaction sample
        budget (None: R * S * global_budget_fraction). ``fparams``: a
        prebuilt ``prepare_field`` result, reused across an image's chunks.

        ``train=True`` is the training forward: differentiable in
        ``params``, the sample comb shifted by ``jitter`` [R] in [0, 1)
        (drawn by the caller; None: no shift), no eval levers. Eval runs
        under ``torch.no_grad``.

        ``mesh``: the rays are this rank's slice of a batch of ``R *
        mesh.size`` rays and ``budget`` is the batch's; every rank calls
        together. The counts in the outputs are this rank's shares.
        """
        if train:
            return self._render(params, rays, binaries, sched, True, budget,
                                fparams, jitter, mesh)
        with torch.no_grad():
            return self._render(params, rays, binaries, sched, False, budget,
                                fparams, None, mesh)

    def _render(self, params, rays, binaries, sched, train, budget, fparams,
                jitter, mesh) -> Dict:
        cfg, scfg = self.config, self.config.sampling
        origins, directions = rays["origins"], rays["directions"]
        R = origins.shape[0]
        S = scfg.max_samples_per_ray
        if not train and scfg.eval_max_samples_per_ray > 0:
            S = min(S, scfg.eval_max_samples_per_ray)
        n_cand = scfg.max_candidates_per_ray

        # eval strided march on the dilated grid: one probe vouches for
        # `stride` candidates while (stride/2) * step <= one cell, which a
        # cone angle's growing steps break; with exact probing the two-phase
        # prefilter starts each ray's fine window at its first occupied
        # coarse probe instead
        march_binaries, occupancy_stride, start_steps = binaries, 1, None
        with spans.span("render:march"):
            if (not train and scfg.eval_coarse_prefilter
                    and binaries is not None and not cfg.disable_occupancy_grid):
                stride = 1
                if scfg.eval_probe_stride > 1 and cfg.cone_angle == 0.0:
                    box = np.asarray(cfg.scene_box, np.float32)
                    cell = float(np.min(box[1] - box[0])) / cfg.grid_resolution
                    stride = min(scfg.eval_probe_stride,
                                 max(int(2.0 * cell / cfg.render_step_size), 1))
                if stride > 1:
                    occupancy_stride = stride
                    march_binaries = dilate_binaries(binaries)
                elif scfg.eval_fine_candidates < n_cand:
                    t_near, t_far = march_range(
                        origins, directions, self.aabb_min, self.aabb_max,
                        binaries, cfg.near_plane, cfg.far_plane)
                    start_steps = coarse_entry_steps(
                        origins, directions, t_near, t_far,
                        dilate_binaries(binaries), self.aabb_min,
                        self.aabb_max, cfg.render_step_size, n_cand,
                        scfg.eval_prefilter_stride, cfg.cone_angle)
                    n_cand = max(scfg.eval_fine_candidates, S)
            samples, info = march_rays(
                origins, directions, self.aabb_min, self.aabb_max,
                cfg.render_step_size, n_cand, S, binaries=march_binaries,
                near_plane=cfg.near_plane, far_plane=cfg.far_plane,
                jitter=jitter, cone_angle=cfg.cone_angle,
                start_steps=start_steps, occupancy_stride=occupancy_stride)

        timesteps = rays.get("timesteps")
        if timesteps is None:
            timesteps = torch.zeros(R, dtype=torch.int64, device=origins.device)
        if fparams is None:
            fparams = self.prepare_field(params)

        mesh = mesh or DataMesh()  # one rank: every collective is the identity
        Rg = R * mesh.size
        if budget is None:
            frac = scfg.global_budget_fraction
            budget = -(-int(Rg * S * frac) // 128) * 128 \
                if 0 < frac < 1.0 else Rg * S
        budget = min(budget, Rg * S)

        # per-ray inputs gathered by one row gather; the timestep (and the
        # camera index, which only the appearance embedding reads, in
        # training) ride as float VALUES (exact below 2^24), never as
        # reinterpreted bits
        cols = [origins, directions, timesteps.to(torch.float32)[:, None]]
        if train and cfg.use_appearance_embedding:
            cams = rays.get("camera_indices")
            if cams is None:
                cams = torch.zeros(R, dtype=torch.int64, device=origins.device)
            cols.append(cams.to(torch.float32)[:, None])
        ray_pack = torch.cat(cols, dim=1)

        n_samples_out = info["n_samples_per_ray"]
        mask_monotone = True  # march_rays fills a valid slot PREFIX per ray
        ps = scfg.eval_termination_probe_stride
        if (not train and scfg.eval_early_stop_trans > 0 and budget < Rg * S
                and ps > 1 and S >= 2 * ps):
            with spans.span("render:sigma_probe"):
                keep = self._probe_termination(params, fparams, samples,
                                               ray_pack, budget, sched, mesh)
            samples = samples._replace(mask=samples.mask & keep)
            n_samples_out = samples.mask.sum(-1)
            mask_monotone = False

        if train and self.evaluates_valid_samples(budget, Rg * S):
            budget = self._dense_budget(samples.mask, mesh)
        with spans.span("render:field"):
            samples, sigmas, rgbs, offsets_norm, n_budget_dropped = \
                self._evaluate_samples(params, fparams, samples, ray_pack,
                                       budget, mask_monotone, sched, train,
                                       mesh)
        if spans.is_on():  # this rank's share of the batch's samples
            spans.tally("samples_valid", n_samples_out.sum())
            spans.tally("samples_evaluated",
                        pad_to_multiple(budget, mesh.size) // mesh.size)
            spans.tally("samples_budget_dropped", n_budget_dropped)

        # alpha_thre pruning (nerfacc's sigma_fn filter): low-opacity samples
        # neither attenuate nor render nor receive gradients; the mask comes
        # from detached sigmas
        if cfg.alpha_thre > 0:
            delta = samples.t_ends - samples.t_starts
            keep = 1.0 - torch.exp(-sigmas.detach() * delta) >= cfg.alpha_thre
            samples = samples._replace(mask=samples.mask & keep)
            sigmas = sigmas * keep

        # early_stop_eps > 0: nerfacc ends a ray once its transmittance falls
        # below eps; the dropped samples neither render nor train. T is
        # monotone along the ray, so the drop is a per-ray suffix: keep
        # sample i iff T before i (without gradient) >= eps
        if cfg.early_stop_eps > 0:
            _, trans = render_weights(sigmas.detach(), samples.t_starts,
                                      samples.t_ends, samples.mask)
            keep = trans >= cfg.early_stop_eps
            samples = samples._replace(mask=samples.mask & keep)
            sigmas = sigmas * keep

        weights, _ = render_weights(sigmas, samples.t_starts, samples.t_ends,
                                    samples.mask)
        outputs = {
            "rgb": render_rgb(weights, rgbs, self.background),
            "accumulation": render_accumulation(weights),
            "depth": render_depth_expected(weights, samples.t_starts,
                                           samples.t_ends),
            "weights": weights,
            "samples": samples,
            "num_samples_per_ray": n_samples_out,
            "num_dropped_per_ray": info["n_dropped_per_ray"],
            "num_budget_dropped": n_budget_dropped,
        }
        if cfg.use_deformation_field:
            outputs["deformation"] = render_expected_value(weights, offsets_norm)
        return outputs

    # -- losses --------------------------------------------------------------

    def compute_losses(self, outputs: Dict, batch: Dict, sched: Dict,
                       train: bool = True, mesh=None) -> Dict[str, torch.Tensor]:
        """Scaled loss dict. batch: rgb [R,3], optional alpha [R] in [0,1],
        optional depth [R] (0 = invalid). With ``mesh`` the batch is this
        rank's slice (``render_rays``): each loss is this rank's share of
        the batch's loss (the means divide by the batch's counts), and
        ``dist_loss_max_rays`` counts the batch's rays."""
        cfg = self.config
        samples, weights = outputs["samples"], outputs["weights"]
        alpha, depth_gt = batch.get("alpha"), batch.get("depth")
        losses = {"rgb_loss": L.masked_rgb_loss(
            outputs["rgb"], batch["rgb"], alpha, cfg.use_masked_rgb_loss,
            cfg.alpha_mask_threshold, mesh)}
        if cfg.lambda_alpha_loss > 0 and alpha is not None:
            losses["alpha_loss"] = cfg.lambda_alpha_loss * L.alpha_loss(
                outputs["accumulation"], alpha, mesh)
        if train and depth_gt is not None:
            eps = sched.get("eps_depth", cfg.eps_depth_final)
            if cfg.lambda_empty_loss > 0:
                losses["empty_loss"] = cfg.lambda_empty_loss * L.empty_loss(
                    weights, samples.t_starts, samples.t_ends, samples.mask,
                    depth_gt, eps, mesh)
            if cfg.lambda_near_loss > 0:
                losses["near_loss"] = cfg.lambda_near_loss * L.near_loss(
                    weights, samples.t_starts, samples.t_ends, samples.mask,
                    depth_gt, eps, mesh)
            if cfg.lambda_depth_loss > 0:
                losses["depth_loss"] = cfg.lambda_depth_loss * L.depth_loss(
                    outputs["depth"], depth_gt, mesh)
        if cfg.lambda_dist_loss > 0 and train:
            R = weights.shape[0]
            first = 0 if mesh is None else mesh.rank * R
            ray_mask = torch.arange(first, first + R, device=weights.device) \
                < cfg.dist_loss_max_rays
            losses["dist_loss"] = cfg.lambda_dist_loss * distortion_loss(
                weights, samples.t_starts, samples.t_ends, samples.mask,
                ray_mask, mesh)
        return losses

    def param_groups(self, params: ParamTree) -> Dict[str, list]:
        """Top-level parameter keys per optimizer group."""
        groups = {"fields": ["field"], "deformation_field": [], "embeddings": []}
        if "deformation" in params:
            groups["deformation_field"].append("deformation")
        for key in ("time_embedding", "time_embedding_deformation"):
            if key in params:
                groups["embeddings"].append(key)
        return groups

    # -- occupancy grid ------------------------------------------------------

    def init_grid_occs(self) -> torch.Tensor:
        cfg = self.config
        return torch.zeros(cfg.grid_levels * cfg.grid_resolution ** 3,
                           dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def density_at(self, params: ParamTree, positions: torch.Tensor,
                   timesteps: torch.Tensor, sched: Dict) -> torch.Tensor:
        """sigma at [N, 3] world positions and [N] integer timesteps, the
        quad table built once, samples in chunks. Over several ranks every
        rank evaluates the same positions (the occupancy update's draws are
        alike on every rank) and gets the same densities."""
        fparams = self.prepare_field(params)
        fparams["tp_rows"] = "replicated"
        return self._chunked_samples(
            lambda p, t: self._density(params, fparams, p, t, sched),
            (positions, timesteps), positions.shape[0])

    def occupancy_grid_update(self, params: ParamTree, grid_occs: torch.Tensor,
                              sched: Dict, warmup: bool,
                              generator: Optional[torch.Generator] = None,
                              draws: Optional[OccupancyDraws] = None) -> torch.Tensor:
        """One EMA update of the grid state; the random draws come from
        ``draws`` or, when None, from ``generator``."""
        cfg = self.config
        if draws is None:
            draws = draw_occupancy(grid_occs.shape[0], cfg.n_timesteps, warmup,
                                   generator)

        def occ_eval_fn(positions, timesteps):
            return self.density_at(params, positions, timesteps, sched) \
                * cfg.render_step_size

        return update_occupancy_grid(
            grid_occs, occ_eval_fn, draws, cfg.grid_resolution, self.aabb_min,
            self.aabb_max, cfg.occ_thre, cfg.occupancy_grid_ema_decay, warmup)
