"""Training (port of nersemble_tpu/engine/trainer.py's ``NeRSembleTrainer``).

A step is ``render_rays(train=True)`` with a per-ray jitter -> the scaled
losses -> backward (kernels B2 and B4 on the GPU) -> ``fused_adam_update``
over the three parameter groups (one kernel launch on the GPU). Around it: the occupancy grid's EMA update
every 16 steps (all cells during warm-up), the adaptive compaction budget
with its fast-grow path, and checkpoints in the JAX package's format that
carry the budget state, so a resumed run makes the same decisions at the
same steps.

Two ways in. ``NeRSembleTrainer(model_config, ...)`` takes its batches from
the caller (``run_step(step, batch)``, ``train_batches``): dicts of tensors
on the trainer's device (the card unless ``device`` says otherwise) with
origins, directions, timesteps, rgb and optional alpha and depth.
``NeRSembleTrainer.from_train_config(config, ...)`` builds a run from a
``TrainConfig`` (what the train CLI does): the capture's dataparser,
datasets and step-indexed ray batcher, the scene box and timestep count,
the frustum mask of the training cameras, the metrics writer, the run
folder and, with ``vis="viewer"``, the live viewer's server; ``train()``
then runs the JAX trainer's loop: ``run_step`` per step, viewer requests
served between steps, metrics every ``steps_per_log`` steps, eval renders
and checkpoints on their cadences, and a final checkpoint. The serving CLIs
(evaluate, render, view) build an ``eval_only`` trainer from a run folder
and render through ``render_image`` and ``viewer_render``.

The initial parameters, the jitter of step ``k`` and the occupancy draws of
an update at step ``k`` come from host generators seeded by (seed, k): a
run resumed from a checkpoint draws what the uninterrupted run drew, and a
run on the card draws what the same run on the CPU draws. Nothing in a step waits for the
device: the batch arrives by a non-blocking copy from page-locked memory
(``data.ray_batcher.DeviceBatches``), and device values are read on the
host only in the cadence branches: the log, the adaptive budget's sample
counts (``_maybe_adapt_budget``), evaluations and checkpoints.

Over several ranks (``mesh``, one process per card; parallel/) each rank
takes its slice of every batch and the step stays the global one that
GSPMD makes of the JAX step: the jitter is drawn for the whole batch and
sliced, the compaction ranks the samples of all rays, the loss means divide
by the batch's counts, the gradients are summed over the ranks, and the
logged values come from all-reduced sums, so every rank adapts the budget
alike. The hash table's layout (``table_layout``) follows the run's
``ParallelConfig`` as in the JAX trainer: the ZeRO-3 entry-sharded table
(``shard_table_params``, the default), the replicated table with sharded
Adam moments (``shard_table_optimizer``), the feature-sharded table
(``shard_hash_tables``) or the replicated table. The occupancy update runs
on every rank with the same draws, so the grids stay equal. Only rank 0
writes metrics, images and checkpoints.
"""

import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nersemble_tpu_torch.config import (
    ModelConfig,
    OptimizerConfig,
    ParallelConfig,
    TrainConfig,
    default_optimizers,
)
from nersemble_tpu_torch.data.dataparser import NeRSembleDataParser
from nersemble_tpu_torch.data.dataset import NeRSembleDataset
from nersemble_tpu_torch.data.multi_view_data import NeRSembleDataManager
from nersemble_tpu_torch.data.ray_batcher import (
    DeviceBatches,
    EvalImageLoader,
    RayBatcher,
)
from nersemble_tpu_torch.engine import checkpoints
from nersemble_tpu_torch.engine.optimizers import (
    fused_adam_update,
    group_of_param,
    init_adam,
)
from nersemble_tpu_torch.engine.renderer import RAY_KEYS, Renderer
from nersemble_tpu_torch.engine.writer import (
    MetricsWriter,
    device_memory_scalars,
    param_count_summary,
)
from nersemble_tpu_torch.models.field import table_row_width
from nersemble_tpu_torch.models.nersemble import NeRSembleModel
from nersemble_tpu_torch.ops.occupancy import (
    OccupancyDraws,
    draw_occupancy,
    frustum_culling_grid,
)
from nersemble_tpu_torch.ops.sampling import quantized_budget
from nersemble_tpu_torch.parallel.mesh import DataMesh
from nersemble_tpu_torch.utils import colormaps as C
from nersemble_tpu_torch.utils import metrics as M
from nersemble_tpu_torch.utils import spans
from nersemble_tpu_torch.utils.device import resolve_device, to_device
from nersemble_tpu_torch.utils.metrics import psnr
from nersemble_tpu_torch.utils.params import ParamTree, to_tree
from nersemble_tpu_torch.utils.windows import lr_values, sched_values

OCC_UPDATE_EVERY = 16
_JITTER, _OCCUPANCY = 0, 1  # generator streams
# the hash table's layout under a mesh (``table_layout``): "replicated"
# (gradient all-reduced), "zero3" (the [E/n, W] entry shard: all-gathered in
# the table dtype for the quad, its folded gradient reduce-scattered),
# "moments" (replicated, Adam moments of an [E/n, W] row shard, gradient
# reduce-scattered and updated rows all-gathered), "tp" (the [E, W/n] column
# shard: the rank's features)
_TABLE = "field.table"


def write_profile(profiler, traced: Dict, counted: Dict, out: Path) -> None:
    """A profiled segment of the loop into ``out``: the profiler's Chrome
    trace (``trace.json``), its operators and kernels by device time
    (``kernels.txt``), and the tracer's spans (``traced``, ``spans.export()``)
    as a Chrome trace on the profiler's clock with the segment's idle gaps
    by span and the counters' change since ``counted`` (``spans.json``)."""
    out.mkdir(parents=True, exist_ok=True)
    profiler.export_chrome_trace(str(out / "trace.json"))
    (out / "kernels.txt").write_text(profiler.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    events = json.loads((out / "trace.json").read_text()).get("traceEvents", [])
    offset = spans.clock_offset(events, traced["spans"])
    trace = spans.chrome_trace(traced["spans"], offset or 0.0)
    trace["idle_by_span"] = spans.idle_by_span(events, traced["spans"])
    trace["counters"] = {k: v - counted.get(k, 0) for k, v in traced["counters"].items()}
    (out / "spans.json").write_text(json.dumps(trace))


class NeRSembleTrainer:
    def __init__(self, model_config: ModelConfig, n_rays: int = 4096,
                 optimizers: Optional[Dict[str, OptimizerConfig]] = None,
                 seed: int = 19980801, device="cuda",
                 params: Optional[ParamTree] = None,
                 grid_occs: Optional[torch.Tensor] = None,
                 grid_mask: Optional[torch.Tensor] = None,
                 eval_only: bool = False, mesh: Optional[DataMesh] = None,
                 parallel: Optional[ParallelConfig] = None):
        """``eval_only``: a trainer that renders and never trains holds no
        Adam moments (3.35 GB at the flagship size). ``mesh``: this rank of
        a data-parallel run (None: one process, no collectives); ``params``
        are then the whole parameters, which the trainer shards by
        ``parallel`` (default ``ParallelConfig()``)."""
        self.device = resolve_device(device)
        self.model = NeRSembleModel(model_config, self.device)
        self.config = self.model.config
        self.optimizers = optimizers or default_optimizers()
        self.n_rays = n_rays
        self.seed = seed
        self.mesh = mesh
        self.is_chief = mesh is None or mesh.rank == 0
        if mesh is not None and n_rays % mesh.size:
            raise ValueError(f"n_rays={n_rays} must divide over {mesh.size} ranks")
        if params is None:  # drawn on the host: the same on every device
            params = self.model.init_params(torch.Generator().manual_seed(seed))
        self.table_layout = self._choose_layout(parallel or ParallelConfig(),
                                                tuple(params.field.table.shape))
        self._set_params(self._shard(params.to(self.device)))
        self.opt_state = None if eval_only else self._init_adam()
        self.grid_occs = grid_occs if grid_occs is not None \
            else self.model.init_grid_occs()
        # [G, G, G] bool ANDed into the sampling binaries (frustum culling)
        self.grid_mask = grid_mask
        self.start_step = 0
        self.writer: Optional[MetricsWriter] = None
        self.train_config: Optional[TrainConfig] = None
        self._eval_only = eval_only
        self._viewer_ranks = False  # from_train_config: the viewer over ranks

        scfg = self.config.sampling
        R, S = n_rays, scfg.max_samples_per_ray
        frac = scfg.global_budget_fraction
        self._budget = -(-int(R * S * frac) // 128) * 128 \
            if 0 < frac < 1.0 else R * S
        # adaptive growth never passes the cap (never below the start budget)
        self._budget_cap = R * S
        chunk = self.config.max_n_samples_per_batch
        if scfg.adaptive_budget and scfg.adaptive_budget_max_chunks > 0 and chunk > 0:
            self._budget_cap = max(self._budget,
                                   scfg.adaptive_budget_max_chunks * chunk)
        self._sample_counts, self._budget_drops = [], []

    def _set_params(self, params: ParamTree) -> None:
        self.params = params
        for p in params.parameters():
            p.requires_grad_(True)
        self.key_to_group = group_of_param(self.model.param_groups(params))

    # -- the table's layout over the ranks -------------------------------------

    def _choose_layout(self, parallel: ParallelConfig, table_shape) -> str:
        """The JAX trainer's choice (trainer.py:86-93, 183-235): the
        feature-sharded table when asked and the row width divides, else
        the ZeRO-3 table or sharded moments when asked and the entries
        divide, else replicated; one rank is always replicated. Any split
        of the row width shards, also one that cuts a logical table of the
        hash ensemble (``models/field.tp_window``)."""
        mesh = self.mesh
        if mesh is None or mesh.size == 1:
            return "replicated"
        n, (E, W) = mesh.size, table_shape
        if parallel.shard_hash_tables:
            if W % n:
                print(f"[nersemble-torch] shard_hash_tables disabled: row width "
                      f"{W} not divisible by {n} devices")
            else:
                self.model.table_layout = ("cols", mesh)
                return "tp"
        if E % n == 0 and parallel.shard_table_params:
            self.model.table_layout = ("rows", mesh)
            return "zero3"
        if E % n == 0 and parallel.shard_table_optimizer:
            return "moments"
        return "replicated"

    def _table_part(self) -> slice:
        """This rank's slice of the whole table's rows (zero3, moments) or
        columns (tp)."""
        E, W = self.model.levels.total_entries, table_row_width(self.config)[0]
        return self.mesh.rows(W if self.table_layout == "tp" else E)

    def _shard(self, params: ParamTree) -> ParamTree:
        """Whole parameters -> this rank's (the table's shard in place)."""
        if self.table_layout in ("zero3", "tp"):
            table = params.field.table
            part = table[:, self._table_part()] if self.table_layout == "tp" \
                else table[self._table_part()]
            params.field.table = torch.nn.Parameter(part.contiguous(),
                                                    requires_grad=False)
        return params

    def _init_adam(self):
        state = init_adam(self.params)
        if self.table_layout == "moments":
            rows = self._table_part()
            for moments in (state.mu, state.nu):
                moments.field.table = torch.nn.Parameter(
                    moments.field.table[rows].contiguous(), requires_grad=False)
        return state

    def _reduce_gradients(self) -> Dict:
        """Sum the gradients over the ranks (the JAX step's psum): one
        all-reduce of every gradient but the table's, then the table's by
        its layout. Returns ``fused_adam_update``'s ``row_shards``."""
        mesh = self.mesh
        named = [(k, p) for k, p in self.params.named_parameters()
                 if p.grad is not None and k != _TABLE]
        flat = mesh.all_reduce_sum(torch.cat([p.grad.reshape(-1) for _, p in named]))
        for (_, p), g in zip(named, flat.split([p.numel() for _, p in named])):
            p.grad = g.view_as(p)
        table = self.params.field.table
        if table.grad is None:
            return {}
        if self.table_layout == "replicated":
            table.grad = mesh.all_reduce_sum(table.grad)
        elif self.table_layout == "moments":
            grad, table.grad = mesh.reduce_scatter_rows(table.grad), None
            return {_TABLE: (self._table_part(), grad)}
        # zero3: the all-gather's backward reduce-scattered it; tp: each
        # rank's tables saw every rank's rows
        return {}

    def _generator(self, step: int, stream: int) -> torch.Generator:
        """A host generator seeded by (seed, stream, step): a run draws the
        same numbers on every device, so a run on the card can be held to
        the same run on the CPU."""
        return torch.Generator().manual_seed(((2 * self.seed + stream) << 32) + step)

    # -- schedules (host side) -------------------------------------------------

    def sched_values(self, step: int) -> Dict[str, float]:
        return sched_values(self.config, step)

    def lr_values(self, step: int) -> Dict[str, float]:
        return lr_values(self.optimizers, step)

    # -- one step -------------------------------------------------------------

    def train_step(self, step: int, batch: Dict[str, torch.Tensor],
                   jitter: Optional[torch.Tensor] = None):
        """Forward, losses, backward and the Adam update at the current
        budget. ``batch`` holds this rank's rays; ``jitter`` [R of the whole
        batch] overrides the step's own draw. Returns (total loss, aux) as
        device tensors: aux holds the loss dict, psnr and the sample counts
        (of the whole batch)."""
        model, mesh = self.model, self.mesh
        sched, lrs = self.sched_values(step), self.lr_values(step)
        binaries = model.binaries(self.grid_occs, self.grid_mask)
        R = batch["origins"].shape[0]
        rows = slice(None) if mesh is None else mesh.rows(R * mesh.size)
        if jitter is None:
            jitter = torch.rand(R if mesh is None else R * mesh.size,
                                generator=self._generator(step, _JITTER))
        jitter = to_device(jitter[rows], self.device)
        with spans.span("train:forward"):
            outputs = model.render_rays(self.params, batch, binaries, sched,
                                        train=True, budget=self._budget,
                                        jitter=jitter, mesh=mesh)
            losses = model.compute_losses(outputs, batch, sched, train=True,
                                          mesh=mesh)
            total = sum(losses.values())
        with spans.span("train:backward"):
            total.backward()
        row_shards = {}
        if mesh is not None:
            with spans.span("train:reduce"):
                row_shards = self._reduce_gradients()
        with spans.span("train:adam"):
            self.opt_state = fused_adam_update(self.params, self.opt_state,
                                               self.key_to_group, lrs,
                                               row_shards=row_shards)
            if self.table_layout == "moments":
                table = self.params.field.table
                with torch.no_grad():
                    table.copy_(mesh.all_gather_rows(table[self._table_part()]))
        for p in self.params.parameters():
            p.grad = None
        if mesh is None:
            aux = {
                "losses": {k: v.detach() for k, v in losses.items()},
                "psnr": psnr(outputs["rgb"].detach(), batch["rgb"]),
                "num_samples": outputs["num_samples_per_ray"].sum(),
                "num_dropped": outputs["num_dropped_per_ray"].sum(),
                "num_budget_dropped": outputs["num_budget_dropped"],
            }
            return total.detach(), aux
        return self._batch_aux(total, losses, outputs, batch)

    def _batch_aux(self, total, losses, outputs, batch):
        """The step's values for the whole batch: one all-reduce of the
        ranks' loss shares, squared errors and sample counts."""
        mesh = self.mesh
        dropped = outputs["num_budget_dropped"]
        if not isinstance(dropped, torch.Tensor):  # every slot evaluated
            dropped = torch.zeros((), device=self.device)
        sse = torch.sum((outputs["rgb"].detach() - batch["rgb"]) ** 2)
        parts = [total.detach(), *(v.detach() for v in losses.values()), sse,
                 outputs["num_samples_per_ray"].sum(),
                 outputs["num_dropped_per_ray"].sum(), dropped]
        sums = mesh.all_reduce_sum(torch.stack([x.to(torch.float64) for x in parts]))
        n = len(losses)
        mse = sums[n + 1] / (batch["rgb"].numel() * mesh.size)
        aux = {
            "losses": {k: sums[1 + i].to(torch.float32)
                       for i, k in enumerate(losses)},
            "psnr": (10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))
                     ).to(torch.float32),
            "num_samples": sums[n + 2],
            "num_dropped": sums[n + 3],
            "num_budget_dropped": sums[n + 4],
        }
        return sums[0].to(torch.float32), aux

    def maybe_update_occupancy(self, step: int) -> None:
        """The grid's EMA update every 16 steps (all cells below
        ``occupancy_grid_warmup_steps``)."""
        cfg = self.config
        if cfg.disable_occupancy_grid or step % OCC_UPDATE_EVERY != 0:
            return
        warmup = step < cfg.occupancy_grid_warmup_steps
        with spans.span("loop:occupancy"):
            draws = draw_occupancy(self.grid_occs.shape[0], cfg.n_timesteps, warmup,
                                   self._generator(step, _OCCUPANCY))
            draws = OccupancyDraws(*(None if d is None else to_device(d, self.device)
                                     for d in draws))
            self.grid_occs = self.model.occupancy_grid_update(
                self.params, self.grid_occs, self.sched_values(step),
                warmup=warmup, draws=draws)

    def _maybe_adapt_budget(self, step: int, aux) -> None:
        """Re-size the compaction budget to the measured valid-sample count
        (``quantized_budget``: quantized, with hysteresis). Counts are read
        on the host only every interval/4 steps (every 25 through the first
        two intervals); a sampled step that dropped more than 2% of its
        valid samples grows the budget at once, shrinks wait for the
        interval boundary. Step-indexed, so a resumed run decides alike. A
        dense march that evaluates each step's valid samples
        (``NeRSembleModel.evaluates_valid_samples``) adapts nothing."""
        scfg = self.config.sampling
        if not scfg.adaptive_budget or self.model.evaluates_valid_samples(
                self._budget, self.n_rays * scfg.max_samples_per_ray):
            return
        interval = max(scfg.adaptive_budget_interval, 1)
        cadence = max(interval // 4, 1)
        if step < 2 * interval:
            cadence = min(cadence, 25)
        if step % cadence != 0:
            return
        with spans.span("loop:budget"):
            self._sample_counts.append(spans.host_value(aux["num_samples"]))
            self._budget_drops.append(spans.host_value(aux["num_budget_dropped"]))
        del self._sample_counts[:-16], self._budget_drops[:-16]
        drop_frac = self._budget_drops[-1] / max(self._sample_counts[-1], 1.0)
        if step == 0 or (step % interval != 0 and drop_frac <= 0.02):
            return
        measured = max(self._sample_counts[-8:])
        new = quantized_budget(measured, self.n_rays, scfg.max_samples_per_ray,
                               headroom=scfg.adaptive_budget_headroom,
                               current=self._budget)
        new = min(new, self._budget_cap)
        if new != self._budget:
            print(f"[nersemble-torch] step {step}: compaction budget "
                  f"{self._budget} -> {new} "
                  f"(measured {measured:.0f} valid samples/batch)")
            if self.writer is not None:
                self.writer.put_scalars(step, {"sample_budget": new})
            self._budget = new

    def run_step(self, step: int, batch: Dict[str, torch.Tensor]):
        """One training iteration as the JAX trainer's loop runs it:
        occupancy update, train step, budget adaptation: the span
        ``loop:step``, which all of the step's spans share."""
        with spans.span("loop:step", step=step):
            self.maybe_update_occupancy(step)
            total, aux = self.train_step(step, batch)
            self._maybe_adapt_budget(step, aux)
        return total, aux

    def train_batches(self, batch_fn: Callable[[int], Dict[str, torch.Tensor]],
                      max_steps: int):
        """``run_step`` from ``start_step`` to ``max_steps`` with the
        step-indexed batches ``batch_fn(step)``; returns the last (total,
        aux)."""
        last = None
        for step in range(self.start_step, max_steps):
            last = self.run_step(step, batch_fn(step))
        self.start_step = max_steps
        return last

    # -- checkpoints -----------------------------------------------------------

    def save_checkpoint(self, path, step: int) -> None:
        """Params, Adam state, grid and the budget state at ``step``. Over
        several ranks every rank calls it: the table's shards are gathered
        to rank 0 in row chunks (no rank holds the whole table twice),
        rank 0 writes the whole checkpoint, and every rank returns when it
        is written."""
        extra = {"sample_budget": np.asarray(self._budget),
                 "sample_counts": np.asarray(self._sample_counts[-16:], np.float64),
                 "budget_drops": np.asarray(self._budget_drops[-16:], np.float64)}
        if self.mesh is None:
            checkpoints.save_checkpoint(path, step, self.params, self.opt_state,
                                        self.grid_occs, extra=extra)
            return
        trees = self.host_trees()
        if self.is_chief:
            checkpoints.write_checkpoint(
                path, step, trees["params"],
                {"count": self.opt_state.count.cpu().numpy(), "mu": trees["mu"],
                 "nu": trees["nu"]}, self.grid_occs.cpu().numpy(), extra)
        self.mesh.barrier()  # every rank returns once the file is there

    def host_trees(self, whats=("params", "mu", "nu")) -> Dict:
        """The whole parameters and Adam moments named in ``whats`` as numpy
        trees on rank 0, every rank calling: {"params", "mu", "nu"}; the
        table's shards gathered in row chunks, None on the other ranks."""
        shards = {"zero3": ("params", "mu", "nu"), "tp": ("params", "mu", "nu"),
                  "moments": ("mu", "nu")}.get(self.table_layout, ())
        trees = {}
        sources = {"params": self.params}
        if self.opt_state is not None:
            sources.update(mu=self.opt_state.mu, nu=self.opt_state.nu)
        copy = (lambda t: t.cpu().numpy()) if self.is_chief else (lambda t: None)
        for what, tree in ((w, sources[w]) for w in whats):
            host = to_tree(tree, copy)
            if what in shards:
                host["field"]["table"] = self._gather_table(tree.field.table)
            trees[what] = host
        return trees

    def _gather_table(self, shard: torch.Tensor,
                      chunk_rows: int = 1 << 18) -> Optional[np.ndarray]:
        """The whole [E, W] table from every rank's shard, on rank 0's host
        (None on the others), all-gathered in chunks of ``chunk_rows`` rows
        of each shard."""
        mesh, n = self.mesh, self.mesh.size
        tp = self.table_layout == "tp"
        E, w = shard.shape
        out = None
        if self.is_chief:
            out = np.empty((E, w * n) if tp else (E * n, w), np.float32)
        for lo in range(0, E, chunk_rows):
            part = mesh.all_gather_rows(shard[lo:lo + chunk_rows])
            if out is None:
                continue
            part = part.cpu().numpy().reshape(n, -1, w)
            c = part.shape[1]
            if tp:
                out[lo:lo + c] = part.transpose(1, 0, 2).reshape(c, n * w)
            else:
                for r in range(n):
                    out[r * E + lo:r * E + lo + c] = part[r]
        return out

    def load_checkpoint(self, path, load_opt: bool = True) -> None:
        """Resume from a checkpoint of either package: training continues at
        its step + 1 with its adapted budget. Without ``load_opt`` the Adam
        state stays as it was (an evaluation never reads it). Over several
        ranks every rank reads the file and keeps its shard of the table and
        of its moments."""
        flat = checkpoints.read_flat(path, skip=None if load_opt else "opt_state/")
        if self.table_layout != "replicated":
            part = self._table_part()
            keys = ["opt_state/mu/field/table", "opt_state/nu/field/table"]
            if self.table_layout != "moments":
                keys.append("params/field/table")
            for key in keys:
                if key in flat:
                    table = flat[key]
                    flat[key] = np.ascontiguousarray(
                        table[:, part] if self.table_layout == "tp" else table[part])
        step, params, opt_state, grid_occs, extra = \
            checkpoints.state_from_flat(flat, self.device, load_opt=load_opt)
        self._set_params(params)
        if load_opt:
            self.opt_state = opt_state
        self.grid_occs = grid_occs
        self.start_step = step + 1
        if int(extra.get("sample_budget", 0)) > 0:
            self._budget = min(int(extra["sample_budget"]), self._budget_cap)
        self._sample_counts = list(np.asarray(extra.get("sample_counts", []),
                                              np.float64))
        self._budget_drops = list(np.asarray(extra.get("budget_drops", []),
                                             np.float64))

    # -- a run built from a TrainConfig ------------------------------------------

    @classmethod
    def from_train_config(cls, config: TrainConfig, model_manager=None,
                          eval_only: bool = False, device="cuda",
                          mesh: Optional[DataMesh] = None):
        """The trainer of a run: data from the capture ``config.data`` names,
        the run folder of ``model_manager`` (else ``output_dir/run_name``),
        and, when ``config.load_dir`` is set, the state of its checkpoint
        (``load_step``, else the latest). Fills ``config.model``'s
        ``n_timesteps``, ``scene_box``, ``num_images`` and the auto-sized
        candidate count, as the JAX trainer does, so the ``config.yml`` saved
        afterwards equals the JAX package's. ``eval_only``: no Adam moments
        are made or read from the checkpoint, and ``train`` raises.
        ``mesh``: this rank of a run over several ranks (parallel/launch.py
        starts them); the table's layout follows ``config.parallel``."""
        device = resolve_device(device)
        dm = NeRSembleDataManager(config.data.participant_id,
                                  config.data.sequence_name)
        dataparser = NeRSembleDataParser(config.data, data_manager=dm)
        train_outputs = dataparser.generate_outputs("train")
        eval_outputs = dataparser.generate_outputs("val")
        config.model.n_timesteps = config.data.n_timesteps
        config.model.scene_box = train_outputs.scene_box.tolist()
        config.model.num_images = train_outputs.n_images

        grid_mask = None
        if config.model.use_view_frustum_culling and train_outputs.frustums:
            grid_mask = torch.from_numpy(frustum_culling_grid(
                train_outputs.frustums, config.model.grid_resolution,
                train_outputs.scene_box[0], train_outputs.scene_box[1],
                config.model.view_frustum_culling)).to(device)
        self = cls(config.model, n_rays=config.data.train_num_rays_per_batch,
                   optimizers=config.optimizers, seed=config.seed,
                   device=device, grid_mask=grid_mask, eval_only=eval_only,
                   mesh=mesh, parallel=config.parallel)
        config.model.sampling.max_candidates_per_ray = \
            self.config.sampling.max_candidates_per_ray
        self.train_config = config
        self.model_manager = model_manager
        self.run_dir = Path(model_manager.get_location()) if model_manager \
            else Path(config.output_dir or ".") / (config.run_name or "run")
        self.dataparser = dataparser
        self.train_outputs, self.eval_outputs = train_outputs, eval_outputs
        self.train_dataset = NeRSembleDataset(train_outputs, config.data)
        self.eval_dataset = NeRSembleDataset(eval_outputs, config.data)
        self.eval_loader = EvalImageLoader(self.eval_dataset)
        self._train_image_loader = EvalImageLoader(self.train_dataset)
        self._eval_batch_iter = None
        self._renderer: Optional[Renderer] = None
        self.step_hook: Optional[Callable] = None
        self.batches: Optional[DeviceBatches] = None
        self.checkpoint_load_s = None
        if config.load_dir is not None:
            self._load_checkpoint()
        self.batcher = RayBatcher(self.train_dataset, config.data,
                                  num_rays=self.n_rays, seed=config.seed)
        # "viewer" serves the live web viewer between steps, with csv metrics
        # (reference: nerfstudio --vis viewer, train_nersemble.py:56)
        self.writer = MetricsWriter(self.run_dir,
                                    enabled=config.vis != "none" and self.is_chief,
                                    mode="csv" if config.vis == "viewer"
                                    else config.vis)
        self.viewer = None
        # over several ranks every rank takes part in serving (rank 0 holds
        # the server): _service_viewer
        self._viewer_ranks = config.vis == "viewer" and mesh is not None \
            and mesh.size > 1
        if config.vis == "viewer" and self.is_chief:
            from nersemble_tpu_torch.viewer import ViewerServer
            _, distance = self.viewer_defaults()
            self.viewer = ViewerServer(state={
                "run_name": config.run_name,
                "n_timesteps": config.data.n_timesteps,
                "step": self.start_step,
                "distance": distance,
            }, port=config.viewer_port)
            print(f"[nersemble-torch] viewer: {self.viewer.url}")
        counts = param_count_summary(self.params)
        if self.table_layout in ("zero3", "tp"):  # the whole table's count
            others = self.params.field.table.numel() * (self.mesh.size - 1)
            counts = {k: v + (others if k in ("field", "total") else 0)
                      for k, v in counts.items()}
        if self.is_chief:
            print("[nersemble-torch] parameters: "
                  + "  ".join(f"{k}={v:,}" for k, v in counts.items()))
        self.writer.put_scalars(self.start_step,
                                {f"params/{k}": v for k, v in counts.items()})
        return self

    def viewer_defaults(self):
        """(orbit center, default distance) in UNSCALED (calibration) units
        — the same units the render CLI's circle trajectory uses before the
        x scale_factor. Derived from the scene box so the orbit frames
        whatever scene is loaded (the real capture's head box or the
        synthetic sphere) instead of hardcoding the head position."""
        box = np.asarray(self.config.scene_box, np.float64) \
            / self.train_config.data.scale_factor
        center = box.mean(axis=0)
        half_diag = float(np.linalg.norm(box[1] - box[0])) / 2.0
        return center, max(0.75 * half_diag, 1e-3)

    def apply_grid_mask(self, mask: np.ndarray) -> None:
        """AND an extra [G, G, G] bool mask (e.g. the eval-time largest-
        connected-component filter) into the sampling binaries. The result
        is a new tensor: the renderer keys its caches on the mask's
        identity. The renderer goes with the old mask, and with it the
        auto budget probed on it."""
        mask = torch.from_numpy(np.asarray(mask, bool)).to(self.device)
        self.grid_mask = mask if self.grid_mask is None else self.grid_mask & mask
        self._renderer = None

    def save_dataparser_transforms(self) -> None:
        """``dataparser_transforms.json`` (nerfstudio's artifact): the world
        transform the dataparser applied, so model outputs are relocatable."""
        path = self.run_dir / "dataparser_transforms.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({
            "transform": np.eye(4)[:3].tolist(),
            "scale": float(self.train_config.data.scale_factor),
        }, indent=2))

    def train(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        """The JAX trainer's loop from ``start_step`` to ``max_steps``
        (default ``max_num_iterations``); returns the last logged scalars
        with ``step`` and ``loss``. ``step_hook(trainer, step, "begin" /
        "end")``, when set, is called around each iteration.
        ``NERSEMBLE_PROFILE_DIR`` traces steps start + 10 to start + 14
        with torch.profiler and the port's tracer (``utils/spans.py``) into
        ``trace.json`` and ``spans.json`` there, and writes the operators
        and kernels by device time to ``kernels.txt`` (rank 0's, over
        several ranks; ``write_profile``). Over several ranks every rank
        runs the loop: each takes its rows of every batch and renders its
        share of every eval image, and rank 0 writes."""
        if self._eval_only:
            raise RuntimeError("this trainer was built with eval_only=True: it "
                               "holds no optimizer state and cannot train")
        if self.train_config is None:
            raise RuntimeError("train() runs a run built by from_train_config; "
                               "train_batches() takes batches from the caller")
        cfg = self.train_config
        max_steps = max_steps or cfg.max_num_iterations
        if self.is_chief:
            self.save_dataparser_transforms()
        # step-indexed batches: a resumed run sees the uninterrupted run's
        rows = slice(None) if self.mesh is None else self.mesh.rows(self.n_rays)
        self.batches = batches = DeviceBatches(self.batcher, self.start_step,
                                               self.device, rows)
        profile_dir = os.environ.get("NERSEMBLE_PROFILE_DIR") \
            if self.is_chief else None
        profiler = tracing = None
        counted = {}
        last = {}
        t_last_log = time.time()
        rays_since_log = 0
        try:
            for step in range(self.start_step, max_steps):
                if profile_dir and step == self.start_step + 10:
                    tracing = not spans.is_on()
                    spans.enable(self.device)
                    counted = spans.counters()
                    profiler = torch.profiler.profile()
                    profiler.start()
                if profiler is not None and step == self.start_step + 15:
                    profiler.stop()
                    write_profile(profiler, spans.export(), counted, Path(profile_dir))
                    if tracing:
                        spans.disable()
                    profiler = None
                if self.step_hook is not None:
                    self.step_hook(self, step, "begin")
                total, aux = self.run_step(step, next(batches))
                rays_since_log += self.n_rays
                self._service_viewer(step)

                if step % cfg.steps_per_log == 0 or step == max_steps - 1:
                    with spans.span("loop:log", step=step):
                        last = self._log(step, total, aux, rays_since_log,
                                         time.time() - t_last_log)
                    t_last_log = time.time()
                    rays_since_log = 0

                if cfg.steps_per_eval_batch and step > 0 \
                        and step % cfg.steps_per_eval_batch == 0:
                    self._eval_batch(step)

                if cfg.steps_per_eval_image and step > 0 \
                        and step % cfg.steps_per_eval_image == 0:
                    self._eval_image(step, image_idx=step // cfg.steps_per_eval_image
                                     % max(len(self.eval_loader), 1))
                    self._train_image(step)

                if cfg.steps_per_eval_all_images and step > 0 \
                        and step % cfg.steps_per_eval_all_images == 0:
                    self._eval_all_images(step)

                if cfg.steps_per_save and step > 0 and step % cfg.steps_per_save == 0:
                    self.save_run_checkpoint(step)

                # the eval renders' quad table (3.3 GB bf16 at the flagship
                # size) is not carried into the next step (the JAX loop's
                # round-4 OOM)
                self._renderer = None
                if self.step_hook is not None:
                    self.step_hook(self, step, "end")
        finally:
            batches.close()
            if profiler is not None:
                profiler.stop()
                if tracing:
                    spans.disable()

        self.save_run_checkpoint(max_steps - 1)
        self.start_step = max_steps
        return last

    def _log(self, step: int, total, aux, rays: int, seconds: float) -> Dict:
        """The log cadence's scalars (reads the step's device values)."""
        read = spans.host_value
        total = read(total)
        scalars = {
            "train_loss": total,
            "train_psnr": read(aux["psnr"]),
            "rays_per_sec": rays / max(seconds, 1e-6),
            "samples_per_batch": read(aux["num_samples"]),
            "dropped_samples_per_batch": read(aux["num_dropped"]),
            **{f"loss/{k}": read(v) for k, v in aux["losses"].items()},
            **{f"lr/{k}": v for k, v in self.lr_values(step).items()},
            **{f"window_param/{k}": v for k, v in self.sched_values(step).items()},
            **device_memory_scalars(self.device),
        }
        if "num_budget_dropped" in aux:
            scalars["budget_dropped_per_batch"] = read(aux["num_budget_dropped"])
        self.writer.put_scalars(step, scalars)
        return {"step": step, "loss": total, **scalars}

    # -- evaluation --------------------------------------------------------------

    def renderer(self) -> Renderer:
        """The renderer of the current parameters and grid, kept for the rest
        of the step so that its eval renders share one quad table (an
        ``eval_only`` trainer keeps it, and its auto budget, across
        images)."""
        if self._renderer is None:
            self._renderer = Renderer(self.model, self.params, self.grid_occs,
                                      self.grid_mask, mesh=self.mesh)
        return self._renderer

    def render_image(self, image_rays: Dict, step: int, chunk: Optional[int] = None,
                     budget=None) -> Dict[str, np.ndarray]:
        """A whole frame in chunks of ``chunk`` rays (default the run's
        ``eval_num_rays_per_batch``); ``budget`` as in
        ``Renderer.render_image`` (None, an int or ``"auto"``)."""
        return self.renderer().render_image(
            image_rays, step,
            chunk=chunk or self.train_config.data.eval_num_rays_per_batch,
            budget=budget)

    def viewer_render(self, params: Dict, step: int) -> np.ndarray:
        """Render one live-viewer frame (orbit camera params from the web
        UI) through the normal render path with the auto budget. Runs on
        the thread that owns the trainer — see viewer/server.py."""
        from nersemble_tpu_torch.data.cameras import generate_image_rays
        from nersemble_tpu_torch.viewer import orbit_pose

        if not hasattr(self, "_viewer_intr"):
            self._viewer_intr = self.dataparser.data_manager \
                .load_camera_params().intrinsics
        data = self.train_config.data
        scale = data.scale_factor
        out = self.train_outputs
        orig_w = out.image_width * data.downscale_factor
        orig_h = out.image_height * data.downscale_factor
        width = int(params["width"])
        height = max(16, round(width * orig_h / orig_w))
        intr = self._viewer_intr.rescale(width / orig_w)
        # same OpenCV -> OpenGL/world-scale pose chain as the render CLI,
        # orbiting the scene-box center (viewer_defaults)
        center, _ = self.viewer_defaults()
        pose = orbit_pose(params["az"], params["el"], params["dist"],
                          center=center)
        p = pose @ np.diag([1.0, -1.0, -1.0, 1.0])
        p[:3, 3] *= scale
        origins, dirs = generate_image_rays(p, intr, height, width)
        t_idx = int(round(float(params["t"]) * max(data.n_timesteps - 1, 0)))
        image_rays = {
            "origins": origins, "directions": dirs,
            "timesteps": np.full(origins.shape[0], t_idx, np.int32),
            "height": height, "width": width,
        }
        rendered = self.render_image(image_rays, step=step, budget="auto")
        channel = params.get("channel", "rgb")
        if channel == "depth":
            return C.apply_depth_colormap(
                rendered["depth"], accumulation=rendered["accumulation"],
                near=0.8 * scale, far=1.2 * scale)
        if channel == "deformation" and "deformation" in rendered:
            return C.apply_scene_flow_colormap(rendered["deformation"])
        return rendered["rgb"]

    def _service_viewer(self, step: int) -> None:
        """Serve the viewer's pending requests on this thread (none waiting:
        no device work and no read). Over several ranks rank 0 shares them
        with every rank, one small host message when there are none, and
        every rank renders each (viewer/server.py ``serve_over_ranks``)."""
        if self._viewer_ranks:
            from nersemble_tpu_torch.viewer import serve_over_ranks
            if self.viewer is not None:
                self.viewer.update_state(step=step)
            serve_over_ranks(self.viewer, self.mesh,
                             lambda p: self.viewer_render(p, step))
            return
        if self.viewer is None:
            return
        self.viewer.update_state(step=step)
        while self.viewer.service(lambda p: self.viewer_render(p, step)):
            pass

    def _eval_batch(self, step: int) -> None:
        """Eval-ray loss batch; one threadless batch generator is reused
        across calls."""
        if self._eval_batch_iter is None:
            eval_batcher = RayBatcher(
                self.eval_dataset, self.train_config.data,
                num_rays=self.train_config.data.eval_num_rays_per_batch,
                seed=self.train_config.seed + 7919)
            self._eval_batch_iter = eval_batcher._generator()
        host = next(self._eval_batch_iter)
        batch = {k: torch.from_numpy(host[k]).to(self.device)
                 for k in (*RAY_KEYS, "rgb")}
        if self.mesh is not None:  # render_chunk takes this rank's rows
            n = self.mesh.size
            if batch["rgb"].shape[0] % n:
                raise ValueError(f"eval_num_rays_per_batch must divide over {n} ranks")
        with torch.no_grad():
            out = self.renderer().render_chunk({k: batch[k] for k in RAY_KEYS},
                                               self.sched_values(step))
        rgb = out["_packed"][:, 0:3]
        self.writer.put_scalars(step, {
            "eval_psnr": float(M.psnr(rgb, batch["rgb"])),
            "eval_mse": float(M.mse(rgb, batch["rgb"])),
        })

    def _eval_image(self, step: int, image_idx: int = 0) -> Dict[str, float]:
        image_rays = self.eval_loader.image_rays(image_idx)
        rendered = self.render_image(image_rays, step)
        gt = image_rays["gt_rgb"]
        regular, masked = M.image_metrics(rendered["rgb"], gt,
                                          image_rays.get("gt_alpha"), self.device)
        scalars = {
            "eval_image_psnr": regular["psnr"],
            "eval_image_ssim": regular["ssim"],
            "eval_image_mse": regular["mse"],
        }
        if regular["lpips"] is not None:
            scalars["eval_image_lpips"] = regular["lpips"]
        for key in ("psnr", "ssim", "mse", "lpips"):
            if masked.get(key) is not None:
                scalars[f"eval_image_{key}_masked"] = masked[key]
        self.writer.put_scalars(step, scalars)
        cam = image_rays["entry"].cam_id
        self.writer.put_image(step, f"cam_{cam}_rgb", rendered["rgb"])
        self.writer.put_image(step, f"cam_{cam}_gt", gt)
        self.writer.put_image(step, f"cam_{cam}_accumulation",
                              C.apply_colormap(rendered["accumulation"]))
        self.writer.put_image(step, f"cam_{cam}_depth",
                              C.apply_depth_colormap(
                                  rendered["depth"],
                                  accumulation=rendered["accumulation"]))
        self.writer.put_image(step, f"cam_{cam}_error",
                              C.apply_error_colormap(rendered["rgb"], gt))
        if "deformation" in rendered:
            self.writer.put_image(step, f"cam_{cam}_deformation",
                                  C.apply_scene_flow_colormap(
                                      rendered["deformation"]))
        return scalars

    def _train_image(self, step: int) -> None:
        """Render one training view for logging."""
        loader = self._train_image_loader
        image_idx = step % max(len(loader), 1)
        image_rays = loader.image_rays(image_idx)
        rendered = self.render_image(image_rays, step)
        self.writer.put_image(step, f"idx_{image_idx}_rgb", rendered["rgb"],
                              group="train_images")
        self.writer.put_image(step, f"idx_{image_idx}_gt", image_rays["gt_rgb"],
                              group="train_images")
        self.writer.put_scalars(step, {"train_image_psnr": float(psnr(
            torch.from_numpy(rendered["rgb"]),
            torch.from_numpy(image_rays["gt_rgb"])))})

    def _eval_all_images(self, step: int) -> None:
        """Average metrics over every eval view, plus per-camera and
        per-timestep PSNR means."""
        psnrs, ssims = [], []
        masked_acc = {"psnr": [], "ssim": [], "mse": [], "lpips": []}
        by_cam, by_t = {}, {}
        for image_idx in range(len(self.eval_loader)):
            image_rays = self.eval_loader.image_rays(image_idx)
            rendered = self.render_image(image_rays, step)
            regular, masked = M.image_metrics(rendered["rgb"],
                                              image_rays["gt_rgb"],
                                              image_rays.get("gt_alpha"),
                                              self.device)
            p = regular["psnr"]
            psnrs.append(p)
            ssims.append(regular["ssim"])
            for key, vals in masked_acc.items():
                if masked.get(key) is not None:
                    vals.append(masked[key])
            entry = image_rays["entry"]
            by_cam.setdefault(entry.cam_id, []).append(p)
            by_t.setdefault(entry.timestep_index, []).append(p)
        scalars = {
            "eval_all_psnr": float(np.mean(psnrs)),
            "eval_all_ssim": float(np.mean(ssims)),
        }
        for key, vals in masked_acc.items():
            if vals:
                scalars[f"eval_all_{key}_masked"] = float(np.mean(vals))
        for cam, vals in sorted(by_cam.items()):
            scalars[f"eval_cam{cam}_psnr"] = float(np.mean(vals))
        if len(by_t) > 1:
            for t, vals in sorted(by_t.items()):
                scalars[f"eval_t{t}_psnr"] = float(np.mean(vals))
        self.writer.put_scalars(step, scalars)

    # -- the run's checkpoints ------------------------------------------------------

    def checkpoint_dir(self) -> Path:
        if self.model_manager:
            return Path(self.model_manager.get_checkpoint_folder())
        return self.run_dir / "checkpoints"

    def save_run_checkpoint(self, step: int) -> None:
        """``checkpoints/step-NNNNNNNNN.ckpt`` of the run, its save time as
        ``checkpoint_save_seconds``, and (``save_only_latest_checkpoint``)
        every older checkpoint deleted."""
        path = self.checkpoint_dir() / f"step-{step:09d}.ckpt"
        t0 = time.time()
        self.save_checkpoint(path, step)
        dt = time.time() - t0
        if dt > 5.0:
            print(f"[nersemble-torch] step {step}: checkpoint saved in {dt:.0f} s")
        self.writer.put_scalars(step, {"checkpoint_save_seconds": dt})
        if self.train_config.save_only_latest_checkpoint and self.is_chief:
            checkpoints.prune_old_checkpoints(self.checkpoint_dir(), step)

    def _load_checkpoint(self) -> None:
        load_dir = Path(self.train_config.load_dir)
        if self.train_config.load_step is not None:
            path = load_dir / f"step-{self.train_config.load_step:09d}.ckpt"
        else:
            steps = sorted(int(p.stem.split("-")[1])
                           for p in load_dir.glob("step-*.ckpt"))
            if not steps:
                raise FileNotFoundError(f"No checkpoints in {load_dir}")
            path = load_dir / f"step-{steps[-1]:09d}.ckpt"
        t0 = time.time()
        self.load_checkpoint(path, load_opt=not self._eval_only)
        self.checkpoint_load_s = time.time() - t0
        if self.is_chief:
            print(f"[nersemble-torch] {path.name} loaded in "
                  f"{self.checkpoint_load_s:.1f} s: step {self.start_step - 1}, "
                  f"budget {self._budget}")
