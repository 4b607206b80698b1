"""Readings that set a dense training cell's limits (``calibrate.py`` for
``loops/train_dense.py``): the compared numbers of sound runs over many
seeds, of the float8 control, and of planted faults, at the cell's own
size, in one process.

    python -m benchmark.calibrate_dense --workload nersemble_seq97.train \\
        --seeds 11,12,13 --mode sound|control|<fault>[,...] [--out FILE]

The faults are ``calibrate.py``'s but the occupancy update's (a dense
march has none), and ``dropped_samples``: the budget of each step, sized
from its valid samples, is cut by an eighth, so the compaction drops
about an eighth of them. Prints one JSON line per seed.
"""

import argparse
import contextlib
import gc
import json
import resource
import sys
from typing import Dict

import torch

from benchmark import calibrate, check
from benchmark.loops.train_dense import DenseTrainCell, numbers, run_reference
from benchmark.reference.nersemble_ref import fake_fp8

FAULTS = ("stale", "stale_table", "stale_embeddings", "half_batch", "altered_batch",
          "dropped_samples")


@contextlib.contextmanager
def fault(mode: str):
    """The program with fault ``mode`` planted (patched in this process)."""
    if mode != "dropped_samples":
        with calibrate.fault(mode):
            yield
        return
    from nersemble_tpu_torch.models.nersemble import NeRSembleModel
    sized = NeRSembleModel._dense_budget

    def short(self, mask, mesh):
        rows = sized(self, mask, mesh)
        return rows - rows // 8
    NeRSembleModel._dense_budget = short
    try:
        yield
    finally:
        NeRSembleModel._dense_budget = sized


def control_numbers(cell: DenseTrainCell) -> Dict[str, float]:
    """The control in the program's place: the float8 reference's readings
    held to the float32 reference's."""
    low = run_reference(cell, quant=fake_fp8, keep=True)
    ref = run_reference(cell, program=low)
    cell.checked.update(losses=low["losses"], samples=low["samples"],
                        dropped=[s - e for s, e in zip(low["samples"], low["evaluated"])],
                        grad_norms={k: (0.0 if v is None else v)
                                    for k, v in low["grad_norms"].items()})
    ref["program_change_norms"] = low["change_norms"]
    return {**numbers(cell, ref), **check.details(cell, ref)}


def readings(config: Dict, traffic: Dict, seed: int, mode: str, device,
             capture_root=None) -> Dict[str, float]:
    cell = DenseTrainCell(config, traffic, seed, device, capture_root=capture_root)
    with fault(mode):
        cell.setup(warm=False)
    cell.close()
    if mode == "control":
        return control_numbers(cell)
    ref = run_reference(cell)
    return {**numbers(cell, ref), **check.details(cell, ref)}


def main(argv=None) -> int:
    from benchmark.run import load_cell
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="sound")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _, config, traffic, _, _ = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate_dense: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for mode in args.mode.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            line = json.dumps({"workload": args.workload, "mode": mode, "seed": seed,
                               **readings(config, traffic, seed, mode, "cuda:0")})
            gc.collect()
            torch.cuda.empty_cache()
            print(line, flush=True)
            print(f"# peak host memory "
                  f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f} GiB, "
                  f"device {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
                  file=sys.stderr, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
