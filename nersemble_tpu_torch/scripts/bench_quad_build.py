"""Micro-bench: formulations of the xz-quad table build and its gradient
fold on the flagship table, and the build's cost ladder, on the GPU (the
port of scripts/bench_quad_build.py).

    python -m nersemble_tpu_torch.scripts.bench_quad_build [--diag]
        [--build-only] [--skip-alt] [--block 2048]

Default mode, on the flagship [6,537,216, 64] bf16 table:
  a) the plain roll+concat build (``quad_kernel.quad_build_plain``);
  b) slice-pair: each roll as an explicit ``cat([seg[s:], seg[:s]])``;
  c) doubled-table: one per-level doubled [2E, W] copy, then every rolled
     segment is one contiguous slice of it;
  fold) the plain fold (``quad_kernel.quad_fold_plain``) and the
     slice-pair fold;
  e) the kernels B3 (build) and B4 (fold).
(b), (c) and the slice-pair fold must equal the plain versions and B3/B4
must be bit-exact, or the script raises.

``--diag`` runs the build's cost ladder instead, each rung a kernel held
bit-exact to its plain version: copy (P2) -> broadcast-quarters (P3) ->
seven-fetch (P4) -> the real build (B3); each rung prints its ms, the
bytes it must move and GB/s. ``--block`` is the ladder's rows per thread
block (the Pallas block; the level layout keeps its 2048-row padding).
Times are CUDA-event means after a warm-up.
"""

import argparse
from typing import Optional, Sequence

import torch

from nersemble_tpu_torch.ops import copy_kernels, quad_kernel
from nersemble_tpu_torch.ops.hash_encoding import HashGridLevels
from nersemble_tpu_torch.utils.device import resolve_device
from nersemble_tpu_torch.utils.timing import cuda_time_ms, nvidia_smi

W = 64  # the flagship table's row: 32 tables x 2 features
ITERS = 10  # timed calls per formulation


def all_quarter_strides(levels):
    """Per-level roll strides of the four quarters (1, z, x, x+z)."""
    return [tuple(0 for _ in levels.x_strides), *quad_kernel.quarter_strides(levels)]


def build_slicepair(table: torch.Tensor, levels) -> torch.Tensor:
    """(b) each level's roll by -s as ``cat([seg[s:], seg[:s]])``."""
    quarters = []
    for strides in all_quarter_strides(levels):
        parts = []
        for l in range(levels.n_levels):
            off, size = levels.offsets[l], levels.sizes[l]
            s = strides[l] % size
            seg = table[off:off + size]
            parts += [seg] if s == 0 else [seg[s:], seg[:s]]
        quarters.append(torch.cat(parts, dim=0))
    return torch.cat(quarters, dim=1)


def build_doubled(table: torch.Tensor, levels) -> torch.Tensor:
    """(c) one [2E, W] copy holding every level segment twice; each rolled
    segment is then one contiguous slice."""
    segs, doff, acc = [], [], 0
    for l in range(levels.n_levels):
        seg = table[levels.offsets[l]:levels.offsets[l] + levels.sizes[l]]
        segs += [seg, seg]
        doff.append(acc)
        acc += 2 * levels.sizes[l]
    doubled = torch.cat(segs, dim=0)
    quarters = []
    for strides in all_quarter_strides(levels):
        parts = []
        for l in range(levels.n_levels):
            start = doff[l] + strides[l] % levels.sizes[l]
            parts.append(doubled[start:start + levels.sizes[l]])
        quarters.append(torch.cat(parts, dim=0))
    return torch.cat(quarters, dim=1)


def fold_slicepair(g: torch.Tensor, levels) -> torch.Tensor:
    """The fold with each inverse roll as a slice pair, summed in f32 in
    quarter order, cast to the gradient dtype."""
    w = g.shape[1] // quad_kernel.N_QUARTERS
    out = []
    for l in range(levels.n_levels):
        off, size = levels.offsets[l], levels.sizes[l]
        acc = None
        for q, strides in enumerate(all_quarter_strides(levels)):
            s = (-strides[l]) % size  # the inverse (positive) roll
            band = g[off:off + size, q * w:(q + 1) * w]
            if s:
                band = torch.cat([band[s:], band[:s]], dim=0)
            band = band.to(torch.float32)
            acc = band if acc is None else acc + band
        out.append(acc.to(g.dtype))
    return torch.cat(out, dim=0)


def _require_equal(got: torch.Tensor, ref: torch.Tensor, what: str) -> None:
    if not torch.equal(got, ref):
        raise AssertionError(f"{what} differs from the plain version")


def run_diagnostics(block: int = copy_kernels.BLOCK) -> dict:
    """The build's cost ladder at the flagship table shape; returns {rung:
    (ms, bytes moved)}."""
    device = resolve_device("cuda")
    levels = HashGridLevels.create()
    E = (levels.total_entries // block) * block  # the ladder ignores levels
    gen = torch.Generator(device=device).manual_seed(0)
    table = torch.randn(levels.total_entries, W, generator=gen,
                        device=device).to(torch.bfloat16)
    x = table[:E]
    print(f"diagnostics: [E={E}, W={W}] bf16, block={block} rows, "
          f"{-(-E // block)} blocks", flush=True)
    in_bytes, out4_bytes = E * W * 2, 4 * E * W * 2
    seven = [x] * 7
    rungs = [
        ("copy   [B,W]->[B,W]   ", lambda: copy_kernels.copy_cuda(x, block),
         lambda: copy_kernels.copy_plain(x), 2 * in_bytes),
        ("bcast  [B,W]->[B,4W]  ", lambda: copy_kernels.bcast_quarters_cuda(x, block),
         lambda: copy_kernels.bcast_quarters_plain(x), in_bytes + out4_bytes),
        ("fetch7 7x[B,W]->[B,4W]", lambda: copy_kernels.fetch7_cuda(*seven, block=block),
         lambda: copy_kernels.fetch7_plain(*seven), in_bytes + out4_bytes),
        ("build  (B3)           ", lambda: quad_kernel.quad_build_cuda(table, levels),
         lambda: quad_kernel.quad_build_plain(table, levels),
         levels.total_entries * W * 2 * 5),
    ]
    results = {}
    for name, kernel, plain, moved in rungs:
        _require_equal(kernel(), plain(), name.split()[0])
        torch.cuda.empty_cache()
        ms = cuda_time_ms(kernel, ITERS)
        results[name.split()[0]] = (ms, moved)
        print(f"{name}: {ms:8.3f} ms (moves {moved / 1e9:.2f} GB, "
              f"{moved / ms / 1e6:.0f} GB/s); bit-exact", flush=True)
    print(f"  (fetch7 loads {7 * in_bytes / 1e9:.2f} GB: seven reads of one "
          "tensor, counted once)", flush=True)
    return results


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build-only", action="store_true",
                    help="time only the build kernel (B3)")
    ap.add_argument("--skip-alt", action="store_true",
                    help="skip the (b)/(c) alternative formulations")
    ap.add_argument("--diag", action="store_true",
                    help="run the build's cost ladder: copy (P2) -> "
                         "broadcast-quarters (P3) -> seven-fetch (P4) -> B3")
    ap.add_argument("--block", type=int, default=copy_kernels.BLOCK,
                    help="the ladder's rows per thread block")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the bench; returns {name: ms} (the ladder's {rung: (ms, bytes)}
    with ``--diag``)."""
    args = parse_args(argv)
    device = resolve_device("cuda")
    print(f"# {nvidia_smi()}", flush=True)
    if args.diag:
        return run_diagnostics(args.block)

    def timed(fn):
        return cuda_time_ms(fn, ITERS)

    levels = HashGridLevels.create()  # flagship: 16 levels, 2^19
    E = levels.total_entries
    gen = torch.Generator(device=device).manual_seed(0)
    table = torch.randn(E, W, generator=gen, device=device).to(torch.bfloat16)
    print(f"table [E={E}, W={W}] bf16 = {E * W * 2 / 1e9:.2f} GB; "
          f"quad out = {E * 4 * W * 2 / 1e9:.2f} GB", flush=True)
    results = {}
    if args.build_only:
        results["e) B3 build"] = timed(lambda: quad_kernel.quad_build_cuda(table, levels))
        print(f"e) B3 build fwd:            {results['e) B3 build']:8.3f} ms", flush=True)
        return results

    ref = quad_kernel.quad_build_plain(table, levels)
    results["a) plain build"] = timed(lambda: quad_kernel.quad_build_plain(table, levels))
    print(f"a) plain roll+concat fwd:   {results['a) plain build']:8.3f} ms", flush=True)
    if not args.skip_alt:
        for key, fn in (("b) slice-pair build", build_slicepair),
                        ("c) doubled-table build", build_doubled)):
            _require_equal(fn(table, levels), ref, key)
            results[key] = timed(lambda: fn(table, levels))
            print(f"{key + ' fwd:':27s} {results[key]:8.3f} ms", flush=True)

    gq = torch.randn(E, 4 * W, generator=gen, device=device).to(torch.bfloat16)
    ref_fold = quad_kernel.quad_fold_plain(gq, levels)
    results["fold) plain"] = timed(lambda: quad_kernel.quad_fold_plain(gq, levels))
    print(f"fold) plain roll+add bwd:   {results['fold) plain']:8.3f} ms", flush=True)
    if not args.skip_alt:
        _require_equal(fold_slicepair(gq, levels), ref_fold, "slice-pair fold")
        results["fold) slice-pair"] = timed(lambda: fold_slicepair(gq, levels))
        print(f"fold) slice-pair:           {results['fold) slice-pair']:8.3f} ms",
              flush=True)

    _require_equal(quad_kernel.quad_build_cuda(table, levels), ref, "B3 build")
    results["e) B3 build"] = timed(lambda: quad_kernel.quad_build_cuda(table, levels))
    print(f"e) B3 build fwd:            {results['e) B3 build']:8.3f} ms (bit-exact)",
          flush=True)
    _require_equal(quad_kernel.quad_fold_cuda(gq, levels), ref_fold, "B4 fold")
    results["fold) B4"] = timed(lambda: quad_kernel.quad_fold_cuda(gq, levels))
    print(f"fold) B4:                   {results['fold) B4']:8.3f} ms (bit-exact)",
          flush=True)
    return results


if __name__ == "__main__":
    main()
