"""The training step machinery (port of nersemble_tpu/engine/trainer.py's
``NeRSembleTrainer`` without its data pipeline, writer and eval loop).

A step is ``render_rays(train=True)`` with a per-ray jitter -> the scaled
losses -> backward (kernels B2 and B4 on the GPU) -> ``fused_adam_update``
over the three parameter groups. Around it: the occupancy grid's EMA update
every 16 steps (all cells during warm-up), the adaptive compaction budget
with its fast-grow path, and checkpoints in the JAX package's format that
carry the budget state, so a resumed run makes the same decisions at the
same steps. Batches come from the caller as dicts of tensors on the
trainer's device (the card unless ``device`` says otherwise): origins,
directions, timesteps, rgb and optional alpha and depth.

The jitter of step ``k`` and the occupancy draws of an update at step ``k``
come from generators seeded by (seed, k): a run resumed from a checkpoint
draws what the uninterrupted run drew. Inside ``train_step`` nothing waits
for the device: sample counts are read on the host only on the adaptive
budget's cadence (``_maybe_adapt_budget``).
"""

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from nersemble_tpu_torch.config import ModelConfig, OptimizerConfig, default_optimizers
from nersemble_tpu_torch.engine import checkpoints
from nersemble_tpu_torch.engine.optimizers import (
    fused_adam_update,
    group_of_param,
    init_adam,
)
from nersemble_tpu_torch.models.nersemble import NeRSembleModel
from nersemble_tpu_torch.ops.sampling import quantized_budget
from nersemble_tpu_torch.utils.device import resolve_device
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
                 grid_occs: Optional[torch.Tensor] = None):
        self.device = resolve_device(device)
        self.model = NeRSembleModel(model_config, self.device)
        self.config = self.model.config
        self.optimizers = optimizers or default_optimizers()
        self.n_rays = n_rays
        self.seed = seed
        if params is None:
            params = self.model.init_params(
                torch.Generator(device=self.device).manual_seed(seed))
        self._set_params(params.to(self.device))
        self.opt_state = init_adam(self.params)
        self.grid_occs = grid_occs if grid_occs is not None \
            else self.model.init_grid_occs()
        self.start_step = 0

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
        return torch.Generator(device=self.device).manual_seed(
            ((2 * self.seed + stream) << 32) + step)

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
        binaries = model.binaries(self.grid_occs)
        if jitter is None:
            jitter = torch.rand(batch["origins"].shape[0],
                                generator=self._generator(step, _JITTER),
                                device=self.device)
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
        self.grid_occs = self.model.occupancy_grid_update(
            self.params, self.grid_occs, self.sched_values(step),
            warmup=step < cfg.occupancy_grid_warmup_steps,
            generator=self._generator(step, _OCCUPANCY))

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
            self._budget = new

    def run_step(self, step: int, batch: Dict[str, torch.Tensor]):
        """One training iteration as the JAX trainer's loop runs it:
        occupancy update, train step, budget adaptation."""
        self.maybe_update_occupancy(step)
        total, aux = self.train_step(step, batch)
        self._maybe_adapt_budget(step, aux)
        return total, aux

    def train(self, batch_fn: Callable[[int], Dict[str, torch.Tensor]],
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

    def load_checkpoint(self, path) -> None:
        """Resume from a checkpoint of either package: training continues at
        its step + 1 with its adapted budget."""
        step, params, opt_state, grid_occs, extra = \
            checkpoints.load_checkpoint(path, self.device)
        self._set_params(params)
        self.opt_state = opt_state
        self.grid_occs = grid_occs
        self.start_step = step + 1
        if int(extra.get("sample_budget", 0)) > 0:
            self._budget = min(int(extra["sample_budget"]), self._budget_cap)
        self._sample_counts = list(np.asarray(extra.get("sample_counts", []),
                                              np.float64))
        self._budget_drops = list(np.asarray(extra.get("budget_drops", []),
                                             np.float64))
