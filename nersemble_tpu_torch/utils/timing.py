"""Device timing and the card's identity for the measurement scripts."""

import subprocess

import torch

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W): the
# bounds that the measurement path reports a kernel's time against.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12


def cuda_time_ms(fn, iters: int = 10, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls after ``warmup``
    calls: CUDA events around the run, then a synchronize."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float = 0.0, bf16_flops: float = 0.0,
             f32_flops: float = 0.0):
    """(least time in ms the card could take, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the operations over the
    peak rate of their type."""
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * (bf16_flops / PEAK_BF16_FLOPS + f32_flops / PEAK_F32_FLOPS)
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def nvidia_smi(fields: str = "name,power.limit") -> str:
    """``nvidia-smi --query-gpu=<fields> --format=csv,noheader`` for the
    first card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
