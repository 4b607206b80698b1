from nersemble_tpu_torch.model_manager.base import NeRSembleModelFolder, NeRSembleModelManager
from nersemble_tpu_torch.model_manager.evaluation import (
    NVSEvaluationMetrics,
    NVSEvaluationMetricsBundle,
    NVSEvaluationResult,
)

__all__ = [
    "NeRSembleModelFolder",
    "NeRSembleModelManager",
    "NVSEvaluationMetrics",
    "NVSEvaluationMetricsBundle",
    "NVSEvaluationResult",
]
