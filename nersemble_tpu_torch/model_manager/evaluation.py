"""Evaluation result schema (the port's copy of
nersemble_tpu/model_manager/evaluation.py; reference:
src/nersemble/model_manager/evaluation.py:7-25).

Persisted as ``evaluation_result.json``:
``{mean, per_cam} x {regular, masked} x {psnr, ssim, lpips, mse, jod}``.
"""

from dataclasses import dataclass, field
from typing import Dict, Optional

from nersemble_tpu_torch.config import ConfigBase


@dataclass
class NVSEvaluationMetrics(ConfigBase):
    psnr: Optional[float] = None
    ssim: Optional[float] = None
    lpips: Optional[float] = None
    mse: Optional[float] = None
    jod: Optional[float] = None


@dataclass
class NVSEvaluationMetricsBundle(ConfigBase):
    regular: NVSEvaluationMetrics = field(default_factory=NVSEvaluationMetrics)
    masked: NVSEvaluationMetrics = field(default_factory=NVSEvaluationMetrics)


@dataclass
class NVSEvaluationResult(ConfigBase):
    mean: NVSEvaluationMetricsBundle = field(default_factory=NVSEvaluationMetricsBundle)
    per_cam: Dict[str, NVSEvaluationMetricsBundle] = field(default_factory=dict)
