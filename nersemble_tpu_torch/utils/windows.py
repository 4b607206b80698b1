"""Coarse-to-fine window functions and host-side schedules.

Port of ``nersemble_tpu/utils/windows.py`` plus the trainer's
``sched_values`` and ``lr_values`` (``nersemble_tpu/engine/trainer.py:404-428``). Schedule
values are plain Python floats computed on the host per step; the window is
evaluated on the device of the tensor it multiplies.
"""

from typing import Dict

import numpy as np
import torch

from nersemble_tpu_torch.config import ModelConfig, OptimizerConfig
from nersemble_tpu_torch.utils.device import device_constant


def posenc_window(window_param: float, min_band: float, max_band: float,
                  n_bands: int, device=None) -> torch.Tensor:
    """Truncated Hann window sliding right along the band spectrum: band
    ``b`` eases in as ``window_param`` goes from ``b`` to ``b + 1``."""
    bands = device_constant(
        tuple(np.linspace(min_band, max_band, n_bands, dtype=np.float32).tolist()),
        torch.float32, torch.device(device or "cpu"))
    x = torch.clamp(float(window_param) - bands, 0.0, 1.0)
    return 0.5 * (1.0 - torch.cos(torch.pi * x))


def generic_schedule(step, init_value: float, final_value: float,
                     begin_step: int, end_step: int) -> float:
    """Linear ramp init -> final over [begin, end]."""
    if end_step <= begin_step:
        return float(final_value)
    frac = np.clip((step - begin_step) / (end_step - begin_step), 0.0, 1.0)
    return float(init_value + (final_value - init_value) * frac)


def step_lr(step, base_lr: float, step_size: int, gamma: float) -> float:
    """StepLR: ``base_lr * gamma^floor(step / step_size)``."""
    return float(base_lr * (gamma ** (step // step_size)))


def lr_values(optimizers: Dict[str, OptimizerConfig], step: int) -> Dict[str, float]:
    """Per-group learning rates at ``step``, rounded to float32 like the JAX
    trainer's ``np.float32`` values (``NeRSembleTrainer.lr_values``)."""
    return {name: float(np.float32(step_lr(step, oc.lr, oc.scheduler_step_size,
                                           oc.scheduler_gamma)))
            for name, oc in optimizers.items()}


def sched_values(config: ModelConfig, step: int) -> Dict[str, float]:
    """Scheduled scalars at ``step`` (window_deform, window_hash, eps_depth),
    each rounded to float32 like the JAX trainer's ``np.float32`` values."""
    sched = {}
    if config.use_deformation_field and config.window_deform_end >= 1:
        sched["window_deform"] = float(np.float32(generic_schedule(
            step, 0.0, config.deformation_field.n_freq_pos,
            config.window_deform_begin, config.window_deform_end)))
    if config.use_hash_ensemble and config.window_hash_encodings_end > 0:
        sched["window_hash"] = float(np.float32(generic_schedule(
            step, 1.0, config.hash_ensemble.n_hash_encodings,
            config.window_hash_encodings_begin,
            config.window_hash_encodings_end)))
    if config.lambda_empty_loss > 0 or config.lambda_near_loss > 0:
        sched["eps_depth"] = float(np.float32(generic_schedule(
            step, config.eps_depth_initial, config.eps_depth_final,
            config.eps_depth_begin_step, config.eps_depth_end_step)))
    return sched
