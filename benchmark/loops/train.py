"""The training loop of a user's run, as one benchmark cell drives it.

Set-up builds what the port's train CLI builds (``build_config`` of the
configuration's CLI flags, the capture's dataparser, dataset and
step-indexed ``RayBatcher``, the frustum grid), with the benchmark's own
seeded weights and occupancy grid, and a ``NeRSembleTrainer`` at the
traffic's start step. The grid is the seeded weights' own: every cell
probed once by the reference in float32 (``probe_every_cell``), as the
loop's warm-up updates probe it, so the first step already marches
through a grid as full as the window's. The loop of ``NeRSembleTrainer.train`` is then
driven step by step: ``run_step(step, next(DeviceBatches))`` (occupancy
update every 16 steps, train step, adaptive budget), and every
``log_every`` steps the device values that the loop's log reads. No
evaluation and no checkpoint runs.

The traffic's start step is one at which the loop updates the occupancy
grid, and every step trains at the configuration's own compaction
budget, as the window does. The first ``check_steps`` steps are the ones the
reference follows (``check.py``); set-up then warms up through the next
occupancy update, and the window measures from there for ``--seconds``.
"""

import gc
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import capture, weights
from benchmark.reference.nersemble_ref import Reference

B1 = 0.9
_T0 = time.perf_counter()


def log(message: str) -> None:
    print(f"# [{time.perf_counter() - _T0:7.1f} s] {message}", file=sys.stderr, flush=True)


def grid_seed(seed: int) -> int:
    """The seed of the starting grid's probes, a stream of its own."""
    return int(np.random.SeedSequence([seed, 1]).generate_state(1, np.uint64)[0])


def trainer_seed(seed: int) -> int:
    """The trainer's seed: its host streams are seeded with (2*seed+k)<<32
    plus the step, which has to stay below 2^64."""
    return seed % (2 ** 30)


def run_config(cfg: Dict, data_root: Path):
    """The port's run configuration of ``cfg``'s train CLI flags on the
    capture at ``data_root``, filled in from the capture as the trainer's
    ``from_train_config`` fills it; and the capture's training outputs."""
    from nersemble_tpu_torch.data.dataparser import NeRSembleDataParser
    from nersemble_tpu_torch.data.multi_view_data import NeRSembleDataManager
    from nersemble_tpu_torch.scripts.train_nersemble import build_config, build_parser

    config = build_config(build_parser().parse_args(cfg["train_cli"]), "benchmark", "")
    for key, value in cfg.get("model_overrides", {}).items():
        setattr(config.model, key, value)
    dm = NeRSembleDataManager(config.data.participant_id, config.data.sequence_name,
                              location=str(data_root))
    outputs = NeRSembleDataParser(config.data, data_manager=dm).generate_outputs("train")
    config.model.n_timesteps = config.data.n_timesteps
    config.model.scene_box = outputs.scene_box.tolist()
    config.model.num_images = outputs.n_images
    return config, outputs


class TrainCell:
    """One run of a training cell: ``setup``, ``window``, then the state
    the check needs (``checked``)."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device,
                 capture_root: Optional[Path] = None):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.capture_root = capture_root or capture.cache_root()
        self.steps_done = 0
        self.batch_wait_s: List[float] = []
        self.log_reads: List[Dict[str, float]] = []

    # -- set-up ----------------------------------------------------------------

    def build(self) -> None:
        """Capture, data pipeline, weights, grid and trainer."""
        from nersemble_tpu_torch.data.dataset import NeRSembleDataset
        from nersemble_tpu_torch.data.ray_batcher import RayBatcher
        from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
        from nersemble_tpu_torch.ops.occupancy import frustum_culling_grid
        from nersemble_tpu_torch.utils.params import ParamTree

        self.data_root = capture.write(self.capture_root, self.traffic["capture"])
        config, outputs = run_config(self.cfg, self.data_root)
        self.model_dict = json.loads(json.dumps(config.model.to_dict()))
        if "model" in self.cfg and self.cfg["model"] != self.model_dict:
            raise ValueError("the configuration file's model differs from the one "
                             "its train_cli builds")
        self.optimizers = {k: v.to_dict() for k, v in config.optimizers.items()}
        grid_mask = None
        if config.model.use_view_frustum_culling and outputs.frustums:
            grid_mask = torch.from_numpy(frustum_culling_grid(
                outputs.frustums, config.model.grid_resolution, outputs.scene_box[0],
                outputs.scene_box[1], config.model.view_frustum_culling)).to(self.device)
        dataset = NeRSembleDataset(outputs, config.data)
        # a long run holds every image in the dataset's cache
        with ThreadPoolExecutor(max_workers=8) as pool:
            list(pool.map(dataset.__getitem__, range(len(dataset))))
        log(f"capture and data pipeline ready: {len(dataset)} images")
        self.scale = config.data.scale_factor
        self.n_rays = config.data.train_num_rays_per_batch
        self.batcher = RayBatcher(dataset, config.data, num_rays=self.n_rays, seed=self.seed)

        self.step = self.traffic["start_step"]
        flat = weights.make(self.model_dict, self.seed, self.device)
        grid = Reference(self.model_dict, self.device).probe_every_cell(
            flat, grid_seed(self.seed), self.step)
        self.start_grid = grid.to("cpu", copy=True)
        self.trainer = NeRSembleTrainer(
            config.model, self.n_rays, optimizers=config.optimizers,
            seed=trainer_seed(self.seed), device=self.device,
            params=ParamTree(weights.nested(flat)), grid_occs=grid, grid_mask=grid_mask)
        occupied = grid > min(float(grid.mean()), config.model.occ_thre)
        log(f"weights and grid ready: {float(occupied.float().mean()):.4f} of the cells occupied")

    def _batches(self):
        from nersemble_tpu_torch.data.ray_batcher import DeviceBatches
        self.batches = DeviceBatches(self.batcher, self.step, self.device)

    def next_batch(self):
        t0 = time.perf_counter()
        batch = next(self.batches)
        self.batch_wait_s.append(time.perf_counter() - t0)
        return batch

    def one_step(self):
        """One iteration of the loop, with its log read on the cadence."""
        batch = self.next_batch()
        total, aux = self.trainer.run_step(self.step, batch)
        if self.step % self.traffic["log_every"] == 0:
            self.log_reads.append({"t": time.perf_counter(),
                "loss": float(total), "psnr": float(aux["psnr"]),
                "samples": float(aux["num_samples"]),
                "dropped": float(aux["num_dropped"]),
                "budget_dropped": float(aux["num_budget_dropped"]),
                **{k: float(v) for k, v in aux["losses"].items()}})
        self.step += 1
        self.steps_done += 1
        return batch, total, aux

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self, warm: bool = True) -> None:
        """Build, run the checked steps, warm up (``warm``); the window
        starts after."""
        self.build()
        self._batches()
        tr = self.trainer
        self.checked = {"batches": [], "losses": [], "samples": [], "dropped": [],
                        "start_step": self.step}
        model = tr.model
        rendered = []

        def render_rays(*args, **kwargs):  # the first step's colour, for the check
            out = type(model).render_rays(model, *args, **kwargs)
            rendered.append(out["rgb"].detach().clone())
            return out
        for k in range(self.traffic["check_steps"]):
            if k == 0:
                model.render_rays = render_rays
            batch, total, aux = self.one_step()
            if k == 0:
                del model.render_rays
                self.checked["colour"] = rendered[-1].cpu()
                # the grid the first step's occupancy update left, which the
                # checked steps march through
                self.checked["grid"] = tr.grid_occs.detach().to("cpu", copy=True)
            self.checked["batches"].append({key: v.clone() for key, v in batch.items()})
            self.checked["losses"].append(float(total))
            self.checked["samples"].append(float(aux["num_samples"]))
            self.checked["dropped"].append(float(aux["num_budget_dropped"]))
            if k == 0:  # the first gradient, as Adam's first moment holds it
                self.checked["grad_norms"] = {
                    name: float(torch.linalg.vector_norm(mu.detach(), dtype=torch.float64))
                    / (1.0 - B1) for name, mu in tr.opt_state.mu.named_parameters()}
        self.checked["params"] = {k: v.detach().to("cpu", copy=True)
                                  for k, v in tr.params.named_parameters()}
        log(f"checked steps done: losses {self.checked['losses']}, "
            f"valid samples {self.checked['samples']}, "
            f"dropped by the budget {self.checked['dropped']}")
        while warm and self.step < self.traffic["window_start_step"]:
            self.one_step()
        self.sync()
        log(f"warm-up done at step {self.step}: "
            f"last log read {self.log_reads[-1] if self.log_reads else None}")

    # -- the window --------------------------------------------------------------

    def window(self, seconds: float, per_step=None) -> Dict[str, float]:
        """Steps for ``seconds`` of host time, ended by a synchronize;
        ``per_step(aux)`` runs after each step (the traced run's counters)."""
        self.batch_wait_s.clear()
        self.log_reads.clear()
        steps0 = self.steps_done
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            _, _, aux = self.one_step()
            if per_step is not None:
                per_step(aux)
        self.sync()
        elapsed = time.perf_counter() - t0
        steps = self.steps_done - steps0
        gaps = np.diff([r["t"] for r in self.log_reads]) * 1e3 / self.traffic["log_every"]
        if len(gaps):
            log(f"ms a step between log reads: min {gaps.min():.2f} median "
                f"{np.median(gaps):.2f} max {gaps.max():.2f}")
        log(f"window: {steps} steps in {elapsed:.3f} s")
        if self.log_reads:
            log("window's log reads, mean a step: valid samples "
                f"{np.mean([r['samples'] for r in self.log_reads]):.0f}, dropped by the "
                f"budget {np.mean([r['budget_dropped'] for r in self.log_reads]):.0f}")
        peak = torch.cuda.max_memory_allocated(self.device) \
            if self.device.type == "cuda" else 0
        return {"seconds": elapsed, "steps": steps, "rays": steps * self.n_rays,
                "peak_bytes": peak}

    def close(self) -> None:
        """Stop the prefetch thread and free the program's state."""
        batches = getattr(self, "batches", None)
        if batches is not None:
            batches.close()
        self.batches = self.trainer = self.batcher = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(ctx) -> Dict:
    """One run of a training cell (``ctx``: ``run.RunContext``): set-up,
    the window, the traced layers when asked, then the check."""
    from benchmark import check, profile, trace
    from benchmark.reference.nersemble_ref import grid_layout

    cell = TrainCell(ctx.config, ctx.traffic, ctx.seed, ctx.device,
                     capture_root=ctx.capture_root)
    cell.setup()
    if ctx.device.type == "cuda":
        cell.setup_peak = torch.cuda.max_memory_allocated(ctx.device)
    timers = None
    evaluated = []
    if ctx.trace:
        timers = trace.LayerTimers(ctx.device, grid_layout(cell.model_dict))
        timers.install()
    setup_s = time.perf_counter() - ctx.t_start
    try:
        win = cell.window(ctx.seconds, per_step=(lambda aux: evaluated.append(
            aux["num_samples"] - aux["num_budget_dropped"])) if ctx.trace else None)
    finally:
        if timers is not None:
            timers.uninstall()
    result = {"metrics": {
        "train_rays_per_s": win["rays"] / win["seconds"],
        "train_peak_gib": win["peak_bytes"] / 2 ** 30,
        "setup_s": setup_s,
    }, "attempted": win["steps"],
        "failed": sum(1 for r in cell.log_reads if not np.isfinite(r["loss"])),
        "peak_bytes": max(win["peak_bytes"], getattr(cell, "setup_peak", 0))}
    if ctx.trace:
        layers = timers.totals()

        def steps():
            for _ in range(ctx.traffic["profile_steps"]):
                with torch.profiler.record_function(profile.STEP_RANGE):
                    cell.one_step()
            cell.sync()
        prof = profile.record(steps, ctx.device)
        result["trace"] = {
            "steps": win["steps"], "window_s": win["seconds"], "layers": layers,
            "batch_wait_s": list(cell.batch_wait_s[:win["steps"]]),
            "evaluated_samples": float(sum(float(e) for e in evaluated)),
            "model": cell.model_dict, "profile": prof}
    cell.close()
    ref = check.run_reference(cell)
    result["numbers"] = check.numbers(cell, ref)
    log(f"check done: {result['numbers']}")
    return result
