"""The whole step's share of the card's bf16 peak (989 TFLOP/s): the
operations of the three MLPs, forward and backward, over the samples the
window's steps evaluated, at the configuration's widths, over the
window's time."""

import importlib.util
from pathlib import Path


def _roofline():
    path = Path(__file__).resolve().parent.parent / "roofline.py"
    spec = importlib.util.spec_from_file_location("benchmark_roofline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read(trace):
    if trace.get("window_s", 0) <= 0 or trace.get("evaluated_samples", 0) <= 0:
        return None
    roofline = _roofline()
    flops = trace["evaluated_samples"] * roofline.model_flops_per_sample(trace["model"])
    return 100.0 * flops / (trace["window_s"] * roofline.PEAK_BF16_FLOPS)
