"""Probe: the row gather's rate on the GPU, ``index_select`` against kernel
P1 at each depth of the JAX probe's sweep (scripts/pallas_gather_probe.py).

    python -m nersemble_tpu_torch.scripts.gather_probe [--rows 1048576]

A random bf16 [entries, width] table (the flagship ensemble's 2^19 hashed
levels by default) and ``rows`` random int32 indices. Each line gives the
mean device time (CUDA events, after a warm-up) and M rows/s; each P1
line also checks its first 1024 rows against ``index_select`` and raises
on a mismatch. ``depth`` is the number of row reads each warp keeps in
flight (csrc/gather_rows.cu).
"""

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from nersemble_tpu_torch.ops import copy_kernels
from nersemble_tpu_torch.utils.device import resolve_device
from nersemble_tpu_torch.utils.timing import cuda_time_ms, nvidia_smi

ROWS, WIDTH, ENTRIES = 1 << 20, 128, 6328832  # the JAX probe's defaults
CHECK_ROWS = 1024
ITERS = 5  # timed calls per line


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--entries", type=int, default=ENTRIES)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the probe; returns {name: ms}."""
    args = parse_args(argv)
    device = resolve_device("cuda")
    E, W, N = args.entries, args.width, args.rows
    gen = torch.Generator(device=device).manual_seed(0)
    table = torch.rand(E, W, generator=gen, device=device).to(torch.bfloat16)
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, E, N)
                           .astype(np.int32)).to(device)
    print(f"# {nvidia_smi()}; table [{E}, {W}] bf16, {N} rows", flush=True)

    results = {}
    ms = cuda_time_ms(lambda: table.index_select(0, idx), ITERS)
    results["index_select"] = ms
    print(f"index_select : {ms:8.3f} ms  ({N / ms / 1000:.1f} M rows/s)", flush=True)
    ref = table.index_select(0, idx[:CHECK_ROWS])
    for depth in copy_kernels.DEPTHS:
        ms = cuda_time_ms(lambda: copy_kernels.gather_rows_cuda(table, idx, depth),
                          ITERS)
        out = copy_kernels.gather_rows_cuda(table, idx, depth)
        if not torch.equal(out[:CHECK_ROWS], ref):
            raise AssertionError(f"P1 at depth {depth} differs from index_select")
        results[f"gather_rows d={depth}"] = ms
        print(f"P1 d={depth:3d}     : {ms:8.3f} ms  ({N / ms / 1000:.1f} M rows/s)"
              f"  correct=True", flush=True)
    return results


if __name__ == "__main__":
    main()
