"""Per-card step of the flagship train step over n cards under ray data
parallelism and the ZeRO-3 entry-sharded table, measured on one card and
projected (port of scripts/bench_projection.py).

    python -m nersemble_tpu_torch.scripts.bench_projection [--n-cards 4] [--iters 10]

The n-card step decomposes into

  per-card step = ray-proportional work at R / n rays with the per-card
                  budget ``quantized_budget(fill / n)``
                + per-card constants on the whole table (the quad build and
                  its gradient's fold run on all E entries on every card)
                - the Adam update of the full table + that of its [E/n, W]
                  shard
                + the collectives: the all-gather of the bf16 table and the
                  reduce-scatter of its folded bf16 gradient.

On one card it measures (1) the replicated train step at R / n rays and
the per-card budget (it includes the whole table's quad build, fold and
Adam), (2) Adam on the [E, W] table and on an [E/n, W] shard, (3) the quad
build (B3) and fold (B4) alone. The projection is (1) - (2 full) + (2
shard) + the collectives' time, which stays an ESTIMATE on one card: a ring
all-gather and reduce-scatter each move (n - 1) / n of the table's bf16
bytes per card, over the card's stated NVLink rate (450 GB/s a direction
on an H100 SXM). With at least n cards visible it also
runs the real n-rank step (NCCL, one process per card, ZeRO-3) on the
whole batch and prints its ms/step and collective host ms beside the
projection. Prints one JSON line.

Runs on the card; ``--device cpu`` with ``--tiny`` exists for the CPU test
(it prints the CPU as its device).
"""

import argparse
import json
import statistics
import time
from typing import Optional, Sequence

import torch

from nersemble_tpu_torch.bench import LRS, SEED, schedule_end
from nersemble_tpu_torch.config import OptimizerConfig, flagship_model_config
from nersemble_tpu_torch.engine.optimizers import fused_adam_update, init_adam
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.models.field import build_levels
from nersemble_tpu_torch.ops.quad_kernel import quad_build, quad_fold
from nersemble_tpu_torch.ops.sampling import quantized_budget
from nersemble_tpu_torch.parallel import compare, launch
from nersemble_tpu_torch.utils.bench_data import STEADY_STATE_FILL, bench_batch, bench_grid
from nersemble_tpu_torch.utils.device import resolve_device
from nersemble_tpu_torch.utils.params import ParamTree
from nersemble_tpu_torch.utils.timing import nvidia_smi
from nersemble_tpu_torch.utils.windows import sched_values

LINK_GBPS = 450.0  # H100 SXM NVLink 4: 900 GB/s both directions together


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-cards", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--tiny", action="store_true")
    return ap.parse_args(argv)


def _timed_ms(fn, iters: int, on_card: bool) -> float:
    """Median host ms of ``fn()`` ending in a synchronize, after one warm-up."""
    fn()
    times = []
    for _ in range(iters):
        if on_card:
            torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        if on_card:
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - start))
    return statistics.median(times)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    n, R = args.n_cards, args.rays
    config = flagship_model_config(tiny=args.tiny)
    S = config.sampling.max_samples_per_ray
    optimizers = {name: OptimizerConfig(lr=lr, scheduler_gamma=1.0)
                  for name, lr in LRS.items()}
    grid = bench_grid(config.grid_resolution)
    step = schedule_end(config)

    # 1. the replicated step at the per-card rays and budget
    budget = quantized_budget(STEADY_STATE_FILL // n, R // n, S)
    trainer = NeRSembleTrainer(config, R // n, optimizers, seed=SEED,
                               device=device, grid_occs=grid.to(device))
    trainer._budget = budget
    batch = bench_batch(R // n, config.n_timesteps, config.grid_resolution, device)
    step_ms = _timed_ms(lambda: trainer.train_step(step, batch), args.iters, on_card)

    # 2. Adam on the whole table and on its shard
    table = trainer.params.field.table.detach()
    E, W = table.shape
    del trainer, batch

    def adam_ms(rows: int) -> float:
        params = ParamTree({"field": {"table": table[:rows].clone()}})
        params.field.table.grad = torch.randn(rows, W, device=device) * 1e-3
        state = init_adam(params)
        return _timed_ms(lambda: fused_adam_update(params, state, {"field": "fields"},
                                                   {"fields": 5e-3}),
                         args.iters, on_card)

    adam_full_ms, adam_shard_ms = adam_ms(E), adam_ms(E // n)

    # 3. the quad build and fold (per-card constants either way)
    levels = build_levels(config)
    cast = table.to(getattr(torch, config.table_dtype)).contiguous()
    build_ms = _timed_ms(lambda: quad_build(cast, levels), args.iters, on_card)
    g = torch.randn(E, 4 * W, device=device).to(cast.dtype)
    fold_ms = _timed_ms(lambda: quad_fold(g, levels), args.iters, on_card)
    del g

    table_bytes = E * W * cast.element_size()
    comms_ms = 2 * (n - 1) / n * table_bytes / (LINK_GBPS * 1e9) * 1e3
    projected = step_ms - adam_full_ms + adam_shard_ms + comms_ms
    result = {
        "metric": f"per_card_step_projection_{n}_cards",
        "unit": "ms",
        "value": round(projected, 2),
        "extra": {
            "measured_step_ms_per_card_rays": round(step_ms, 2),
            "measured_adam_full_table_ms": round(adam_full_ms, 3),
            "measured_adam_shard_ms": round(adam_shard_ms, 3),
            "measured_quad_build_ms": round(build_ms, 3),
            "measured_quad_fold_ms": round(fold_ms, 3),
            "estimated_comms_ms": round(comms_ms, 3),
            "comms_estimate_basis": f"2 (n-1)/n x {table_bytes} B at "
                                    f"{LINK_GBPS} GB/s (stated, not measured)",
            "n_rays_per_card": R // n,
            "budget_per_card": budget,
            "table_shape": [E, W],
            "device": torch.cuda.get_device_name(device) if on_card else "cpu",
            "card": nvidia_smi() if on_card else None,
        },
    }
    if on_card and torch.cuda.device_count() >= n > 1:
        result["extra"]["measured_n_rank_step"] = n_rank_step(config, n, R, grid,
                                                              step, args.iters)
    print(json.dumps(result), flush=True)
    return result


def n_rank_step(config, n: int, R: int, grid, step: int, iters: int) -> dict:
    """The real step over n cards (NCCL, ZeRO-3) on the whole batch at the
    whole budget: median ms/step and collective host ms per step after one
    warm-up step, every rank's peak GiB."""
    batch = {k: v.cpu().numpy() for k, v in
             bench_batch(R, config.n_timesteps, config.grid_resolution, "cpu").items()}
    sched = sched_values(config, step)
    spec = {"config": config, "layout": "zero3", "params": None,
            "grid_occs": grid.numpy(), "batches": [batch] * (iters + 1),
            "jitters": None, "sched": sched, "lrs": LRS, "device": "cuda",
            "budget": quantized_budget(STEADY_STATE_FILL, R,
                                       config.sampling.max_samples_per_ray)}
    out = launch.spawn(compare.run_steps, n, "nccl", "cuda", spec)
    return {"ranks": n, "layout": out["layout"],
            "ms_per_step": round(statistics.median(out["ms_per_step"][1:]), 2),
            "collective_host_ms_per_step": round(
                statistics.median(out["comm_ms_per_step"][1:]), 3),
            "peak_gib_per_rank": [round(x, 2) for x in out["peak_gib"]],
            "replicas_equal": out["replicas_equal"]}


if __name__ == "__main__":
    main()
