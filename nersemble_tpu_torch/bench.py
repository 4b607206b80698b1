"""Benchmark: train-step throughput (rays/s/chip) of the flagship model on
the GPU, the port's counterpart of the JAX package's ``bench.py``.

    python -m nersemble_tpu_torch.bench [--iters 30] [--trace DIR]

Runs the training configuration (32-table 2^19 hash ensemble, 6x128 SE(3)
deformation field, occupancy-aware sampling, all six losses, Adam) on the
JAX bench's fixed random rays and synthetic grid: 4096 rays, S=256, 768
candidates, the steady-state compaction budget ``quantized_budget(63188,
4096, 256)`` = 73,728, the schedule at its end and constant group learning
rates. ``NeRSembleTrainer.train_step`` runs once to warm up, then
``--iters`` timed steps that end in a synchronize. Prints ONE JSON line
with bench.py's keys but its ``vs_baseline``; ``extra`` adds
``power_limit``, so that the number carries its card.

Runs on the card; ``--device cpu`` (with ``--tiny`` and a few ``--rays``)
exists for the CPU test.
"""

import argparse
import json
import math
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from nersemble_tpu_torch.config import OptimizerConfig, flagship_model_config
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.ops.sampling import quantized_budget
from nersemble_tpu_torch.utils.bench_data import (
    STEADY_STATE_FILL,
    bench_batch,
    bench_grid,
)
from nersemble_tpu_torch.utils.device import resolve_device
from nersemble_tpu_torch.utils.timing import nvidia_smi

LRS = {"fields": 5e-3, "deformation_field": 1e-3, "embeddings": 5e-3}
SEED = 0
TRACE_STEPS = 3


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fraction", type=float, default=None,
                    help="override sampling.global_budget_fraction")
    ap.add_argument("--chunk", type=int, default=None,
                    help="override max_n_samples_per_batch")
    ap.add_argument("--budget", type=int, default=None,
                    help="explicit compaction budget (overrides --fraction)")
    ap.add_argument("--fill", type=float, default=None,
                    help="the synthetic grid's random fill fraction (0.05)")
    ap.add_argument("--from-run", type=str, default=None,
                    help="a run directory of either package: bench on the "
                         "occupancy grid and adapted budget of its newest "
                         "checkpoints/step-*.ckpt")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--trace", type=str, default=None,
                    help="write a torch.profiler Chrome trace of 3 steps to "
                         "this directory and print its top kernels")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu (the CPU test)")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny test-size config instead of the flagship")
    ap.add_argument("--rays", type=int, default=4096)
    return ap.parse_args(argv)


def newest_checkpoint(run_dir) -> Path:
    ckpts = sorted(Path(run_dir, "checkpoints").glob("step-*.ckpt"))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints/step-*.ckpt under {run_dir}")
    return ckpts[-1]


def schedule_end(config) -> int:
    """A step past every schedule's end (deformation and hash windows,
    eps_depth): the bench's fixed sched."""
    return max(config.window_deform_end, config.window_hash_encodings_end,
               config.eps_depth_end_step) + 1


def print_trace(prof, out_dir: Path) -> None:
    """Export the Chrome trace and print the top kernels by device time."""
    from torch.autograd import DeviceType

    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "train_step_trace.json"
    prof.export_chrome_trace(str(path))
    averages = prof.key_averages()
    # record_function ranges show as device annotations too: keep kernels
    ranges = {e.key for e in averages if e.device_type == DeviceType.CPU}
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA and e.key not in ranges]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in events)
    print(f"# trace {path}: {len(events)} kernels, "
          f"{total / 1e3 / TRACE_STEPS:.2f} ms of kernels per step", flush=True)
    for e in events[:15]:
        print(f"# {e.self_device_time_total / 1e3 / TRACE_STEPS:8.3f} ms/step "
              f"{100 * e.self_device_time_total / max(total, 1):5.1f}% "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the bench; print and return its JSON result."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    config = flagship_model_config(tiny=args.tiny)
    n_rays = args.rays
    if not args.tiny:
        assert config.sampling.max_samples_per_ray == 256
        assert config.sampling.max_candidates_per_ray == -1  # auto-span (-> 768)
    if args.fraction is not None:
        config.sampling.global_budget_fraction = args.fraction
    if args.chunk is not None:
        config.max_n_samples_per_batch = args.chunk
    S = config.sampling.max_samples_per_ray

    budget = args.budget
    if args.from_run:
        with np.load(newest_checkpoint(args.from_run), allow_pickle=False) as data:
            grid = torch.from_numpy(np.asarray(data["grid_occs"], np.float32))
            ckpt_budget = int(data["extra/sample_budget"]) \
                if "extra/sample_budget" in data.files else None
        if budget is None:
            budget = ckpt_budget
    else:
        grid = bench_grid(config.grid_resolution,
                          0.05 if args.fill is None else args.fill)
    if budget is None and args.fraction is None:
        budget = quantized_budget(STEADY_STATE_FILL, n_rays, S)

    optimizers = {name: OptimizerConfig(lr=lr, scheduler_gamma=1.0)
                  for name, lr in LRS.items()}
    trainer = NeRSembleTrainer(config, n_rays, optimizers, seed=SEED,
                               device=device, grid_occs=grid.to(device))
    if budget is not None:
        trainer._budget = budget
    if args.from_run:
        fill = float(trainer.model.binaries(trainer.grid_occs).float().mean())
        print(f"# from-run grid: fill={fill:.4f} adapted_budget={ckpt_budget}",
              flush=True)
    batch = bench_batch(n_rays, config.n_timesteps,
                        None if args.from_run else config.grid_resolution, device)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    step = schedule_end(config)
    total, aux = trainer.train_step(step, batch)  # warm-up
    sync()
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=activities) as prof:
            for i in range(TRACE_STEPS):
                trainer.train_step(step + 1 + i, batch)
            sync()
        print_trace(prof, Path(args.trace))
        step += TRACE_STEPS

    t0 = time.perf_counter()
    for i in range(args.iters):
        total, aux = trainer.train_step(step + 1 + i, batch)
    sync()
    dt = time.perf_counter() - t0

    loss = float(total)
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    rays_per_sec = n_rays * args.iters / dt
    result = {
        "metric": "train_rays_per_sec_per_chip",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "extra": {
            "ray_samples_per_sec": round(float(aux["num_samples"]) * args.iters / dt, 1),
            "step_ms": round(dt / args.iters * 1000, 2),
            "n_rays": n_rays,
            "budget": trainer._budget,
            "n_candidates": trainer.config.sampling.max_candidates_per_ray,
            "device": (torch.cuda.get_device_name(device) if on_card
                       else "cpu").replace(" ", "_"),
            "loss": loss,
            "power_limit": nvidia_smi("power.limit") if on_card else None,
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
