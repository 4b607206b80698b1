"""Checkpoint forensics of a dynamic run: does every timestep train?

Reads only what the port already computes. For the run's last checkpoint
(or ``--step``'s):

1. per timestep row, the norm of ``time_embedding`` and of
   ``time_embedding_deformation`` and the largest Adam second moment ``nu``
   of the row. A row that never received a gradient keeps its initial norm
   and a ``nu`` of exactly 0;
2. on the run's training batch of the step after the checkpoint, a
   histogram of the timesteps that reach the model's time codes
   (``NeRSembleModel._time_codes``, after the compaction's row gather of
   the packed ray data), beside the histogram of the batch's rays. A
   sample histogram with one timestep where the rays have many means the
   indices were lost on the way.

The last line is one JSON object with both. Runs on the GPU unless
``--device cpu``.

Usage:
    NERSEMBLE_DATA_PATH=<captures> NERSEMBLE_MODELS_PATH=<runs> \\
      python -m nersemble_tpu_torch.scripts.dynamic_forensics NERS-001-quality-dynamic
"""

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nersemble_tpu_torch.utils.device import resolve_device

TIME_KEYS = ("time_embedding", "time_embedding_deformation")


def last_checkpoint(run_dir: Path, step: Optional[int] = None) -> Path:
    ckpts = sorted((Path(run_dir) / "checkpoints").glob("step-*.ckpt"))
    if step is not None:
        ckpts = [c for c in ckpts if int(c.stem.split("-")[1]) == step]
    if not ckpts:
        raise FileNotFoundError(f"no checkpoint{'' if step is None else f' of step {step}'} "
                                f"in {run_dir}")
    return ckpts[-1]


def row_report(flat: dict) -> dict:
    """Per time-embedding leaf: each row's norm and its largest Adam ``nu``,
    and the rows whose ``nu`` is exactly 0 (no gradient ever)."""
    report = {}
    for key in TIME_KEYS:
        if f"params/{key}" not in flat:
            continue
        rows = np.asarray(flat[f"params/{key}"], np.float64)
        nu = np.asarray(flat[f"opt_state/nu/{key}"], np.float64)
        nu_max = np.abs(nu).max(axis=1)
        report[key] = {"norm": np.linalg.norm(rows, axis=1).tolist(),
                       "nu_max": nu_max.tolist(),
                       "rows_without_gradient": np.flatnonzero(nu_max == 0).tolist()}
    return report


def sample_timesteps(trainer, step: int) -> dict:
    """Histograms of the timesteps of the batch of ``step``: its rays', and
    the samples' that reach ``_time_codes`` in one training step."""
    from nersemble_tpu_torch.data.ray_batcher import DeviceBatches

    model = trainer.model
    seen = []
    time_codes = model._time_codes

    def recording(params, timesteps):
        seen.append(timesteps.detach())
        return time_codes(params, timesteps)

    batches = DeviceBatches(trainer.batcher, step, trainer.device)
    try:
        batch = next(batches)
    finally:
        batches.close()
    model._time_codes = recording
    try:
        trainer.train_step(step, batch)
    finally:
        del model._time_codes
    T = trainer.config.n_timesteps
    samples = torch.cat(seen) if seen else torch.zeros(0, dtype=torch.long)
    return {"rays": torch.bincount(batch["timesteps"].long().reshape(-1),
                                   minlength=T).tolist(),
            "samples": torch.bincount(samples.long().reshape(-1), minlength=T).tolist(),
            "calls": len(seen)}


def run(run_name: str, step: Optional[int] = None, device="cuda") -> dict:
    from nersemble_tpu_torch.engine import checkpoints
    from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
    from nersemble_tpu_torch.model_manager import NeRSembleModelFolder

    device = resolve_device(device)
    manager = NeRSembleModelFolder().open_run(run_name)
    ckpt = last_checkpoint(Path(manager.get_location()), step)
    report = {"run": run_name, "checkpoint": ckpt.name,
              "rows": row_report(checkpoints.read_flat(ckpt))}
    config = manager.load_config()
    config.load_dir = manager.get_checkpoint_folder()
    config.load_step = int(ckpt.stem.split("-")[1])
    config.vis = "none"
    trainer = NeRSembleTrainer.from_train_config(config, model_manager=manager,
                                                 device=device)
    report["timesteps"] = sample_timesteps(trainer, trainer.start_step)
    return report


def print_report(report: dict) -> None:
    for key, rows in report["rows"].items():
        print(f"[forensics] {key}: row norms "
              f"{[round(v, 5) for v in rows['norm']]}; largest Adam nu per row "
              f"{[float(f'{v:.3e}') for v in rows['nu_max']]}; rows without a "
              f"gradient {rows['rows_without_gradient']}")
    hist = report["timesteps"]
    print(f"[forensics] timesteps of one batch: rays {hist['rays']}; samples "
          f"reaching the time codes ({hist['calls']} calls) {hist['samples']}")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("run", help="run name under $NERSEMBLE_MODELS_PATH/nersemble")
    ap.add_argument("--step", type=int, default=None,
                    help="the checkpoint's step (default: the last)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default: the GPU)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    report = run(args.run, args.step, args.device)
    print_report(report)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
