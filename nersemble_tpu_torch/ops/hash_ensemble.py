"""Hash-ensemble blend-code scheduling (port of
nersemble_tpu/ops/hash_ensemble.py::effective_blend_code).

The Hann window over the table axis, the forced all-ones code while only
table 0 is active (``disable_initial_hash_ensemble``) and the lerp from a
one-hot code to the learned code for window in [1, 2)
(``use_soft_transition``) compose into one effective [N, H] code.
"""

from typing import Optional

import torch

from nersemble_tpu_torch.utils.windows import posenc_window


def effective_blend_code(code: torch.Tensor,
                         window_param: Optional[float],
                         n_tables: int,
                         disable_initial_hash_ensemble: bool = False,
                         use_soft_transition: bool = False) -> torch.Tensor:
    """[N, H] learned code (+ host scalar window) -> effective blend code."""
    if window_param is None:
        return code
    w = float(window_param)
    base = code
    if use_soft_transition and w < 2.0:
        alpha = min(max(w - 1.0, 0.0), 1.0)
        e0 = torch.zeros_like(code)
        e0[:, 0] = 1.0
        base = alpha * code + (1.0 - alpha) * e0
    if disable_initial_hash_ensemble and w <= 1.0:
        base = torch.ones_like(code)
    window = posenc_window(w, 0.0, n_tables - 1, n_tables, code.device)
    return base * window[None, :]
