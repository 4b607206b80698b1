"""Training (port of nersemble_tpu/engine/trainer.py's ``NeRSembleTrainer``).

A step is ``render_rays(train=True)`` with a per-ray jitter -> the scaled
losses -> backward (kernels B2 and B4 on the GPU) -> ``fused_adam_update``
over the three parameter groups. Around it: the occupancy grid's EMA update
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
"""

import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from nersemble_tpu_torch.config import (
    ModelConfig,
    OptimizerConfig,
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
from nersemble_tpu_torch.models.nersemble import NeRSembleModel
from nersemble_tpu_torch.ops.occupancy import (
    OccupancyDraws,
    draw_occupancy,
    frustum_culling_grid,
)
from nersemble_tpu_torch.ops.sampling import quantized_budget
from nersemble_tpu_torch.utils import colormaps as C
from nersemble_tpu_torch.utils import metrics as M
from nersemble_tpu_torch.utils.device import resolve_device, to_device
from nersemble_tpu_torch.utils.metrics import psnr
from nersemble_tpu_torch.utils.params import ParamTree
from nersemble_tpu_torch.utils.windows import lr_values, sched_values

OCC_UPDATE_EVERY = 16
_JITTER, _OCCUPANCY = 0, 1  # generator streams


class NeRSembleTrainer:
    def __init__(self, model_config: ModelConfig, n_rays: int = 4096,
                 optimizers: Optional[Dict[str, OptimizerConfig]] = None,
                 seed: int = 19980801, device="cuda",
                 params: Optional[ParamTree] = None,
                 grid_occs: Optional[torch.Tensor] = None,
                 grid_mask: Optional[torch.Tensor] = None,
                 eval_only: bool = False):
        """``eval_only``: a trainer that renders and never trains holds no
        Adam moments (3.35 GB at the flagship size)."""
        self.device = resolve_device(device)
        self.model = NeRSembleModel(model_config, self.device)
        self.config = self.model.config
        self.optimizers = optimizers or default_optimizers()
        self.n_rays = n_rays
        self.seed = seed
        if params is None:  # drawn on the host: the same on every device
            params = self.model.init_params(torch.Generator().manual_seed(seed))
        self._set_params(params.to(self.device))
        self.opt_state = None if eval_only else init_adam(self.params)
        self.grid_occs = grid_occs if grid_occs is not None \
            else self.model.init_grid_occs()
        # [G, G, G] bool ANDed into the sampling binaries (frustum culling)
        self.grid_mask = grid_mask
        self.start_step = 0
        self.writer: Optional[MetricsWriter] = None
        self.train_config: Optional[TrainConfig] = None
        self._eval_only = eval_only

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
        budget. ``jitter`` [R] overrides the step's own draw. Returns (total
        loss, aux) as device tensors: aux holds the loss dict, psnr and the
        sample counts."""
        model = self.model
        sched, lrs = self.sched_values(step), self.lr_values(step)
        binaries = model.binaries(self.grid_occs, self.grid_mask)
        if jitter is None:
            jitter = to_device(torch.rand(
                batch["origins"].shape[0], generator=self._generator(step, _JITTER)),
                self.device)
        with record_function("train:forward"):
            outputs = model.render_rays(self.params, batch, binaries, sched,
                                        train=True, budget=self._budget,
                                        jitter=jitter)
            losses = model.compute_losses(outputs, batch, sched, train=True)
            total = sum(losses.values())
        with record_function("train:backward"):
            total.backward()
        with record_function("train:adam"):
            self.opt_state = fused_adam_update(self.params, self.opt_state,
                                               self.key_to_group, lrs)
        for p in self.params.parameters():
            p.grad = None
        aux = {
            "losses": {k: v.detach() for k, v in losses.items()},
            "psnr": psnr(outputs["rgb"].detach(), batch["rgb"]),
            "num_samples": outputs["num_samples_per_ray"].sum(),
            "num_dropped": outputs["num_dropped_per_ray"].sum(),
            "num_budget_dropped": outputs["num_budget_dropped"],
        }
        return total.detach(), aux

    def maybe_update_occupancy(self, step: int) -> None:
        """The grid's EMA update every 16 steps (all cells below
        ``occupancy_grid_warmup_steps``)."""
        cfg = self.config
        if cfg.disable_occupancy_grid or step % OCC_UPDATE_EVERY != 0:
            return
        warmup = step < cfg.occupancy_grid_warmup_steps
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
        interval boundary. Step-indexed, so a resumed run decides alike."""
        scfg = self.config.sampling
        if not scfg.adaptive_budget:
            return
        interval = max(scfg.adaptive_budget_interval, 1)
        cadence = max(interval // 4, 1)
        if step < 2 * interval:
            cadence = min(cadence, 25)
        if step % cadence != 0:
            return
        self._sample_counts.append(float(aux["num_samples"]))
        self._budget_drops.append(float(aux["num_budget_dropped"]))
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
        occupancy update, train step, budget adaptation."""
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
        """Params, Adam state, grid and the budget state at ``step``."""
        extra = {"sample_budget": np.asarray(self._budget),
                 "sample_counts": np.asarray(self._sample_counts[-16:], np.float64),
                 "budget_drops": np.asarray(self._budget_drops[-16:], np.float64)}
        checkpoints.save_checkpoint(path, step, self.params, self.opt_state,
                                    self.grid_occs, extra=extra)

    def load_checkpoint(self, path, load_opt: bool = True) -> None:
        """Resume from a checkpoint of either package: training continues at
        its step + 1 with its adapted budget. Without ``load_opt`` the Adam
        state stays as it was (an evaluation never reads it)."""
        step, params, opt_state, grid_occs, extra = \
            checkpoints.load_checkpoint(path, self.device, load_opt=load_opt)
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
                          eval_only: bool = False, device="cuda"):
        """The trainer of a run: data from the capture ``config.data`` names,
        the run folder of ``model_manager`` (else ``output_dir/run_name``),
        and, when ``config.load_dir`` is set, the state of its checkpoint
        (``load_step``, else the latest). Fills ``config.model``'s
        ``n_timesteps``, ``scene_box``, ``num_images`` and the auto-sized
        candidate count, as the JAX trainer does, so the ``config.yml`` saved
        afterwards equals the JAX package's. ``eval_only``: no Adam moments
        are made or read from the checkpoint, and ``train`` raises."""
        device = resolve_device(device)
        if config.parallel.data_axis_size not in (-1, 1):
            raise NotImplementedError(
                f"data_axis_size={config.parallel.data_axis_size}: the port "
                f"trains on one device (multi-GPU is ROADMAP A6)")
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
                   device=device, grid_mask=grid_mask, eval_only=eval_only)
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
        self.writer = MetricsWriter(self.run_dir, enabled=config.vis != "none",
                                    mode="csv" if config.vis == "viewer"
                                    else config.vis)
        self.viewer = None
        if config.vis == "viewer":
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
        with torch.profiler into ``trace.json`` there, and writes the
        operators and kernels by device time to ``kernels.txt``."""
        if self._eval_only:
            raise RuntimeError("this trainer was built with eval_only=True: it "
                               "holds no optimizer state and cannot train")
        if self.train_config is None:
            raise RuntimeError("train() runs a run built by from_train_config; "
                               "train_batches() takes batches from the caller")
        cfg = self.train_config
        max_steps = max_steps or cfg.max_num_iterations
        self.save_dataparser_transforms()
        # step-indexed batches: a resumed run sees the uninterrupted run's
        self.batches = batches = DeviceBatches(self.batcher, self.start_step,
                                               self.device)
        profile_dir = os.environ.get("NERSEMBLE_PROFILE_DIR")
        profiler = None
        last = {}
        t_last_log = time.time()
        rays_since_log = 0
        try:
            for step in range(self.start_step, max_steps):
                if profile_dir and step == self.start_step + 10:
                    profiler = torch.profiler.profile()
                    profiler.start()
                if profiler is not None and step == self.start_step + 15:
                    profiler.stop()
                    out = Path(profile_dir)
                    out.mkdir(parents=True, exist_ok=True)
                    profiler.export_chrome_trace(str(out / "trace.json"))
                    (out / "kernels.txt").write_text(profiler.key_averages().table(
                        sort_by="self_device_time_total", row_limit=40))
                    profiler = None
                if self.step_hook is not None:
                    self.step_hook(self, step, "begin")
                total, aux = self.run_step(step, next(batches))
                rays_since_log += self.n_rays
                self._service_viewer(step)

                if step % cfg.steps_per_log == 0 or step == max_steps - 1:
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

        self.save_run_checkpoint(max_steps - 1)
        self.start_step = max_steps
        return last

    def _log(self, step: int, total, aux, rays: int, seconds: float) -> Dict:
        """The log cadence's scalars (reads the step's device values)."""
        total = float(total)
        scalars = {
            "train_loss": total,
            "train_psnr": float(aux["psnr"]),
            "rays_per_sec": rays / max(seconds, 1e-6),
            "samples_per_batch": float(aux["num_samples"]),
            "dropped_samples_per_batch": float(aux["num_dropped"]),
            **{f"loss/{k}": float(v) for k, v in aux["losses"].items()},
            **{f"lr/{k}": v for k, v in self.lr_values(step).items()},
            **{f"window_param/{k}": v for k, v in self.sched_values(step).items()},
            **device_memory_scalars(self.device),
        }
        if "num_budget_dropped" in aux:
            scalars["budget_dropped_per_batch"] = float(aux["num_budget_dropped"])
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
                                      self.grid_mask)
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
        no device work and no read)."""
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
        if self.train_config.save_only_latest_checkpoint:
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
        print(f"[nersemble-torch] {path.name} loaded in "
              f"{self.checkpoint_load_s:.1f} s: step {self.start_step - 1}, "
              f"budget {self._budget}")
