"""Metrics writer (port of nersemble_tpu/engine/writer.py).

- a JSONL event stream (``metrics.jsonl``), always written when enabled;
- per-image PNG dumps under ``train_images/`` / ``eval_images/``
  (utils/png.py);
- optionally TensorBoard (``vis="tensorboard"``, through torch's
  SummaryWriter) mirroring every scalar and image.

Scalars include losses, metrics, window/scheduler params, throughput,
step timings, and device-memory gauges.
"""

import json
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from nersemble_tpu_torch.utils import png


class MetricsWriter:
    def __init__(self, run_dir, enabled: bool = True, mode: str = "csv"):
        self.run_dir = Path(run_dir)
        self.enabled = enabled
        self._file = None
        self._tb = None
        if enabled:
            self.run_dir.mkdir(parents=True, exist_ok=True)
            self._file = open(self.run_dir / "metrics.jsonl", "a", buffering=1)
            if mode == "tensorboard":
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._tb = SummaryWriter(str(self.run_dir / "tensorboard"))
                except ImportError as ex:  # the tensorboard package is missing
                    print(f"[nersemble-torch] tensorboard unavailable ({ex}); "
                          f"falling back to JSONL only")
        self._start = time.time()

    def put_scalars(self, step: int, scalars: Dict[str, float],
                    prefix: str = "") -> None:
        if not self.enabled:
            return
        record = {"step": int(step), "wall": round(time.time() - self._start, 3)}
        for key, value in scalars.items():
            record[f"{prefix}{key}"] = float(value)
        self._file.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for key, value in scalars.items():
                self._tb.add_scalar(f"{prefix}{key}", float(value), int(step))

    def put_image(self, step: int, name: str, image: np.ndarray,
                  group: str = "eval_images") -> None:
        """image: [H, W, 3] float in [0, 1] or uint8."""
        if not self.enabled:
            return
        if image.dtype != np.uint8:
            image = (np.clip(image, 0, 1) * 255).round().astype(np.uint8)
        path = self.run_dir / group / f"step-{step:09d}" / f"{name}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        png.imwrite(path, image)
        if self._tb is not None:
            self._tb.add_image(f"{group}/{name}", image, int(step),
                               dataformats="HWC")

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._tb is not None:
            self._tb.close()


def device_memory_scalars(device) -> Dict[str, float]:
    """Device memory gauges in GiB (the reference logs
    torch.cuda.max_memory_allocated): memory/gib_in_use,
    memory/peak_gib_in_use, memory/gib_limit. Empty on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"memory/gib_in_use": stats["allocated_bytes.all.current"] / 2 ** 30,
            "memory/peak_gib_in_use": stats["allocated_bytes.all.peak"] / 2 ** 30,
            "memory/gib_limit":
                torch.cuda.get_device_properties(device).total_memory / 2 ** 30}


def param_count_summary(params: torch.nn.Module) -> Dict[str, int]:
    """Per-top-level-key parameter counts of a ParamTree + total (the
    reference prints a torchinfo model summary at startup)."""
    counts = {}
    for key, value in params.named_children():
        counts[key] = sum(p.numel() for p in value.parameters())
    for key, value in params.named_parameters(recurse=False):
        counts[key] = value.numel()
    counts["total"] = sum(counts.values())
    return counts
