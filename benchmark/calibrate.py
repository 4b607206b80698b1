"""Readings that set a training cell's limits: the compared numbers of sound
runs of the program over many seeds, of the control, and of planted
faults, at the cell's own size, in one process.

    python -m benchmark.calibrate --workload <name> --seeds 11,12,13 \\
        --mode sound|control|<fault> [--out FILE]

Each seed builds the cell and runs its checked steps (no window; the
readings need none), then the reference. ``control`` puts the reference
computed with float8 operands (``nersemble_ref.fake_fp8``: the precision
below the configuration's bfloat16) in the program's place and compares
it with the float32 reference. The faults break the program's timed path
underneath, by patching it in this process: ``stale`` (the optimizer
returns its state unchanged), ``stale_table`` and ``stale_embeddings``
(it leaves the table, or the time embeddings, and their moments
unchanged), ``altered_occupancy`` (one cell's value zeroed where the
occupancy update produces the grid), ``half_batch`` (the step trains on the first half of its
rays, the losses the means over them), ``altered_batch`` (one ray's
colour changed where the batch is delivered). Prints one JSON line per
seed.
"""

import argparse
import contextlib
import gc
import json
import resource
import sys
from typing import Dict

import torch

from benchmark import check
from benchmark.loops.train import TrainCell
from benchmark.reference import batch_check
from benchmark.reference.nersemble_ref import fake_fp8, group_of

FAULTS = ("stale", "stale_table", "stale_embeddings", "altered_occupancy", "half_batch",
          "altered_batch")


@contextlib.contextmanager
def fault(mode: str):
    """The program with fault ``mode`` planted (patched in this process)."""
    from nersemble_tpu_torch.data import ray_batcher
    from nersemble_tpu_torch.engine import trainer as trainer_mod
    patches = []

    def patch(owner, name, value):
        patches.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if mode == "stale":
        patch(trainer_mod, "fused_adam_update", lambda params, state, *a, **k: state)
    elif mode in ("stale_table", "stale_embeddings"):
        adam = trainer_mod.fused_adam_update
        stale = (lambda n: n == check.TABLE) if mode == "stale_table" \
            else (lambda n: group_of(n) == "embeddings")

        def skip_some(params, state, *a, **k):
            # a leaf without a gradient is one the update passes over
            held = [(p, p.grad) for n, p in params.named_parameters() if stale(n)]
            for p, _ in held:
                p.grad = None
            try:
                return adam(params, state, *a, **k)
            finally:
                for p, g in held:
                    p.grad = g
        patch(trainer_mod, "fused_adam_update", skip_some)
    elif mode == "altered_occupancy":
        update = trainer_mod.NeRSembleModel.occupancy_grid_update

        def altered(self, *a, **k):
            grid = update(self, *a, **k)
            return grid.index_fill(0, grid.argmax().reshape(1), 0.0)
        patch(trainer_mod.NeRSembleModel, "occupancy_grid_update", altered)
    elif mode == "half_batch":
        orig = trainer_mod.NeRSembleTrainer.train_step

        def half(self, step, batch, jitter=None):
            n = batch["origins"].shape[0] // 2
            return orig(self, step, {k: v[:n] for k, v in batch.items()}, jitter)
        patch(trainer_mod.NeRSembleTrainer, "train_step", half)
    elif mode == "altered_batch":
        orig_next = ray_batcher.DeviceBatches.__next__
        patch(ray_batcher.DeviceBatches, "__next__",
              lambda self: batch_check.alter(orig_next(self)))
    elif mode not in ("sound", "control"):
        raise ValueError(f"unknown mode {mode!r}")
    try:
        yield
    finally:
        for owner, name, value in reversed(patches):
            setattr(owner, name, value)


def control_numbers(cell: TrainCell) -> Dict[str, float]:
    """The control in the program's place: the float8 reference's readings
    held to the float32 reference's."""
    low = check.run_reference(cell, quant=fake_fp8, keep=True, own_grid=True)
    ref = check.run_reference(cell, program=low)
    cell.checked.update(losses=low["losses"], samples=low["samples"],
                        dropped=[s - e for s, e in zip(low["samples"], low["evaluated"])],
                        grad_norms={k: (0.0 if v is None else v)
                                    for k, v in low["grad_norms"].items()})
    ref["program_change_norms"] = low["change_norms"]
    return {**check.numbers(cell, ref), **check.details(cell, ref)}


def readings(config: Dict, traffic: Dict, seed: int, mode: str, device,
             capture_root=None) -> Dict[str, float]:
    cell = TrainCell(config, traffic, seed, device, capture_root=capture_root)
    with fault(mode):
        cell.setup(warm=False)
    cell.close()
    if mode == "control":
        return control_numbers(cell)
    ref = check.run_reference(cell)
    return {**check.numbers(cell, ref), **check.details(cell, ref)}


def main(argv=None) -> int:
    from benchmark.run import load_cell
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="sound")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    workload, config, traffic, _, _ = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                           **readings(config, traffic, seed, args.mode, "cuda:0")})
        gc.collect()
        print(line, flush=True)
        print(f"# peak host memory {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f}"
              f" GiB, device {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
              file=sys.stderr, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
