"""JOD perceptual video metric plumbing (FovVideoVDP); the port's copy of
nersemble_tpu/utils/jod.py.

Reference: scripts/evaluate/evaluate_nersemble.py:48,206-240 — builds a
``pyfvvdp.fvvdp(display_name='standard_4k')`` evaluator and scores per-camera
uint8 frame stacks (regular and alpha-blended) at an effective
``fps = 73 / skips`` (clamped to >= 4.1, the evaluator's minimum).

Evaluator resolution: pyfvvdp when it is importable, else the vendored
pipeline (utils/fvvdp.py, numpy + scipy on the host), else None, in which
case ``jod`` stays null in evaluation_result.json. Tests inject a fake
evaluator through ``set_jod_evaluator_factory``.
"""

import os
from typing import Callable, Optional

import numpy as np

_evaluator_factory: Optional[Callable] = None
_cached = None


def set_jod_evaluator_factory(factory: Optional[Callable]) -> None:
    """Test hook: inject a fake evaluator factory (None resets)."""
    global _evaluator_factory, _cached
    _evaluator_factory = factory
    _cached = None


def get_jod_evaluator():
    """The fvvdp evaluator, or None when neither pyfvvdp nor the vendored
    pipeline is available."""
    global _cached
    if _cached is not None:
        return _cached
    if _evaluator_factory is not None:
        _cached = _evaluator_factory()
        return _cached
    try:
        import pyfvvdp  # noqa: F401 — optional dependency
        _cached = pyfvvdp.fvvdp(display_name="standard_4k", heatmap=None)
        return _cached
    except Exception:
        pass
    # vendored pipeline (utils/fvvdp.py): preferred only when the real
    # pyfvvdp is unavailable; scores are framework-internally comparable
    # but only coarsely calibrated to pyfvvdp's absolute JOD values (see
    # its module docstring). Opt out with NERSEMBLE_DISABLE_VENDORED_JOD=1
    # to keep jod null instead.
    if os.environ.get("NERSEMBLE_DISABLE_VENDORED_JOD") == "1":
        _cached = None
        return _cached
    try:
        from nersemble_tpu_torch.utils.fvvdp import VendoredFovVideoVDP
        _cached = VendoredFovVideoVDP()
    except ImportError:
        _cached = None
    return _cached


def evaluation_fps(skip_timesteps_data: int, n_timesteps: int,
                   max_eval_timesteps: int,
                   skip_timesteps_eval: Optional[int]) -> float:
    """Effective playback fps of the evaluated frame sequence
    (reference: evaluate_nersemble.py:206-214). The capture rig runs 73 fps;
    both the dataparser's frame skip and the evaluation's timestep subsetting
    slow the sequence down."""
    fps = 73.0 / max(skip_timesteps_data, 1)
    if skip_timesteps_eval is not None and skip_timesteps_eval > 1:
        fps /= skip_timesteps_eval
    elif max_eval_timesteps > 0 and n_timesteps > 0:
        fps /= n_timesteps / max_eval_timesteps
    return fps


def jod_score(evaluator, frames_pred: np.ndarray, frames_gt: np.ndarray,
              fps: float) -> float:
    """Score stacked [T, H, W, C] uint8 frame sequences."""
    jod, _ = evaluator.predict(frames_pred, frames_gt, dim_order="FHWC",
                               frames_per_second=max(4.1, fps))
    return float(jod.item()) if hasattr(jod, "item") else float(jod)
