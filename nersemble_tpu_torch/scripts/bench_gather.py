"""Micro-benchmarks of the hash table's gather and scatter economics on the
GPU (the port of scripts/bench_gather.py).

    python -m nersemble_tpu_torch.scripts.bench_gather

Library-call yardsticks for the encode, not the port's code path:
``index_select`` row gathers from f32/bf16 [E, 128] and f32 [E, 64] tables,
``index_add_`` scatters in f32 and bf16, the quad build forward and
forward+backward (``build_quad_table``: B3, and B4 in the backward), and one
8192-sample blended-encode chunk forward and forward+backward. E is the
flagship level layout's 6,537,216 entries. Times are CUDA-event means after
a warm-up.
"""

import numpy as np
import torch

from nersemble_tpu_torch.ops.hash_encoding import (
    HashGridLevels,
    build_quad_table,
    hash_encode_blended,
)
from nersemble_tpu_torch.utils.device import resolve_device
from nersemble_tpu_torch.utils.timing import cuda_time_ms, nvidia_smi

ROWS = 524288         # gathered / scattered rows per call
ENCODE_ROWS = 8192
ITERS = 5             # timed calls per line


def main() -> dict:
    """Run the benchmarks; returns {name: ms}."""
    device = resolve_device("cuda")
    levels = HashGridLevels.create()  # flagship: 16 levels, 2^19
    E, n_rows = levels.total_entries, ROWS
    gen = torch.Generator(device=device).manual_seed(0)
    print(f"# {nvidia_smi()}; E = {E}", flush=True)
    results = {}

    def report(name, fn, rows=None):
        ms = cuda_time_ms(fn, ITERS)
        results[name] = ms
        rate = f" ({rows / ms / 1000:.1f} M rows/s)" if rows else ""
        print(f"{name:40s} {ms:8.3f} ms{rate}", flush=True)

    t64_f32 = torch.rand(E, 64, generator=gen, device=device)
    t128_f32 = torch.rand(E, 128, generator=gen, device=device)
    t128_bf16 = t128_f32.to(torch.bfloat16)
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, E, n_rows)
                           .astype(np.int64)).to(device)
    for name, tab in (("f32 [E,128]", t128_f32), ("bf16 [E,128]", t128_bf16),
                      ("f32 [E,64]", t64_f32)):
        report(f"gather {name} {n_rows} rows", lambda: tab.index_select(0, idx),
               n_rows)
    del t128_f32, t128_bf16
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        upd = torch.rand(n_rows, 128, generator=gen, device=device).to(dtype)
        report(f"scatter {name} [E,128] {n_rows} rows",
               lambda: torch.zeros(E, 128, dtype=dtype, device=device)
               .index_add_(0, idx, upd), n_rows)
        del upd
    torch.cuda.empty_cache()

    report("build_quad_table [E,64]->bf16 [E,256]",
           lambda: build_quad_table(t64_f32, levels, torch.bfloat16))
    table = t64_f32.clone().requires_grad_(True)

    def build_fwd_bwd():
        quad = build_quad_table(table, levels, torch.bfloat16)
        (quad.to(torch.float32) * 1e-3).sum().backward()
        table.grad = None
    report("build_quad_table fwd+bwd", build_fwd_bwd)

    x = torch.rand(ENCODE_ROWS, 3, generator=gen, device=device) * 0.9 + 0.05
    code = torch.randn(ENCODE_ROWS, 32, generator=gen, device=device)
    with torch.no_grad():
        quad = build_quad_table(t64_f32, levels, torch.bfloat16)
        report(f"encode chunk ({ENCODE_ROWS}) fwd",
               lambda: hash_encode_blended(quad, x, code, levels, 2))
    del quad
    xg = x.clone().requires_grad_(True)
    cg = code.clone().requires_grad_(True)

    def encode_fwd_bwd():
        quad = build_quad_table(table, levels, torch.bfloat16)
        (hash_encode_blended(quad, xg, cg, levels, 2) ** 2).sum().backward()
        table.grad = xg.grad = cg.grad = None
    report("encode chunk + build fwd+bwd", encode_fwd_bwd)
    return results


if __name__ == "__main__":
    main()
