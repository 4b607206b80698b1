"""SHA-256 digests of the blended encode's kernels (A3-fwd, A3-bwd) on the
flagship case, the [6,537,216, 256] bf16 quad table at 73,728 samples, and
on the column case, the single grid's one-feature column (what each of two
ranks holds under the feature-sharded layout): a [6,184,960, 4] quad table
in bf16 and in f32 at 73,728 samples.

    python -m nersemble_tpu_torch.scripts.encode_digests [--cases column]
    PYTHONPATH=<checkout> python <this file>   # an older checkout's kernels

Prints one JSON line: the digest of each output (flagship: out, CG, BH,
d_table, d_code, d_wy, d_fx, d_fz; column, per dtype: out, CG, d_table,
d_wy, d_fx, d_fz), the card and its power limit. The inputs owe
nothing to a random generator of PyTorch: the table is an integer hash of
each element's index, the positions (half uniform, a quarter in the grid's
centre block, a quarter at the origin), the codes (the time embedding's
contrast scale) and the output gradient come from a numpy seed. Two
checkouts whose kernels sum in the same orders print the same digests;
chip_smoke.py holds the kernels to the digests of an earlier commit's. It
imports only what the port has had since its blended-encode kernels, so
the same file digests an older checkout of the package.
"""

import argparse
import dataclasses
import hashlib
import json
import math

import numpy as np
import torch

from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.models.field import build_levels
from nersemble_tpu_torch.ops import hash_encoding as he
from nersemble_tpu_torch.utils.cameras import CONTRAST_SCALES
from nersemble_tpu_torch.utils.timing import nvidia_smi

SEED = 0
SAMPLES = 73728   # the bench's budget
WIDTH = 256       # 32 tables x 2 features x 4 quarters
FL = 2
CODE_STD = 0.01 / math.sqrt(32)  # the time embedding's init (models/nersemble.py)
NAMES = ("out", "CG", "BH", "d_table", "d_code", "d_wy", "d_fx", "d_fz")
COLUMN_NAMES = ("out", "CG", "d_table", "d_wy", "d_fx", "d_fz")  # no code, no BH
COLUMN_DTYPES = ("bfloat16", "float32")
ROWS = 1 << 20  # rows per block when building and hashing the table


def flagship_levels():
    hc = flagship_model_config(tiny=False).hash_ensemble.hash_encoding
    return he.HashGridLevels.create(hc.n_levels, hc.log2_hashmap_size,
                                    hc.base_resolution, hc.per_level_scale)


def single_grid_levels():
    """The single grid's layout at the flagship's level settings (16
    levels, 2^19 rows, resolution 16 to 2048: [6,184,960, 2])."""
    return build_levels(dataclasses.replace(flagship_model_config(tiny=False),
                                            use_hash_ensemble=False))


def hashed_table(rows: int, width: int, dtype, device) -> torch.Tensor:
    """[rows, width]: an integer hash of each element's index, in
    [-0.3, 0.3)."""
    table = torch.empty(rows, width, dtype=dtype, device=device)
    for lo in range(0, rows, ROWS):
        hi = min(lo + ROWS, rows)
        i = torch.arange(lo * width, hi * width, dtype=torch.int64, device=device)
        h = (i * 2654435761) % (1 << 32)
        table[lo:hi] = ((h.to(torch.float64) / 2 ** 32 - 0.5) * 0.6).to(
            dtype).reshape(hi - lo, width)
    return table


def positions(rng) -> np.ndarray:
    """[SAMPLES, 3]: half uniform, a quarter in the grid's centre block, a
    quarter at the origin (one corner per level takes them all: hot runs
    across many chunks of the sorted keys)."""
    x = rng.uniform(size=(SAMPLES, 3)).astype(np.float32)
    q = SAMPLES // 4
    x[2 * q:3 * q] = 0.375 + 0.25 * x[2 * q:3 * q]
    x[3 * q:] = 0.0
    return x


def flagship_inputs(device):
    """(forward arguments, output gradient) of the flagship case on
    ``device``."""
    levels = flagship_levels()
    table = hashed_table(levels.total_entries, WIDTH, torch.bfloat16, device)
    rng = np.random.default_rng(SEED)
    x = positions(rng)
    code = (rng.normal(size=(SAMPLES, WIDTH // 4 // FL)) * CODE_STD
            * CONTRAST_SCALES["time_embedding"]).astype(np.float32)
    gbar = rng.normal(size=(SAMPLES, levels.n_levels * FL)).astype(np.float32)
    entry_idx, wy, fx, fz = he.hash_grid_indices(torch.from_numpy(x).to(device), levels)
    args = (table, torch.from_numpy(code).to(device), wy, fx.contiguous(),
            fz.contiguous(), entry_idx, levels.n_levels, FL, True)
    return args, torch.from_numpy(gbar).to(device)


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's values as f32 (exact for bf16), in row blocks."""
    h = hashlib.sha256()
    flat = t.reshape(t.shape[0], -1) if t.dim() else t.reshape(1, 1)
    for lo in range(0, flat.shape[0], ROWS):
        h.update(flat[lo:lo + ROWS].float().cpu().numpy().tobytes())
    return h.hexdigest()


def column_inputs(device, dtype):
    """(forward arguments, output gradient) of the column case in ``dtype``
    on ``device``: the flagship case's positions (the same seed), a
    [E, 4] hashed quad table and an output gradient [n, L]."""
    levels = single_grid_levels()
    table = hashed_table(levels.total_entries, 4, dtype, device)
    rng = np.random.default_rng(SEED)
    x = positions(rng)
    gbar = rng.normal(size=(SAMPLES, levels.n_levels)).astype(np.float32)
    entry_idx, wy, fx, fz = he.hash_grid_indices(torch.from_numpy(x).to(device), levels)
    args = (table, None, wy, fx.contiguous(), fz.contiguous(), entry_idx,
            levels.n_levels, 1, True)
    return args, torch.from_numpy(gbar).to(device)


def kernel_digests(args, gbar, names) -> dict:
    """{output name: SHA-256} of one forward and one backward of the
    kernels on these inputs; ``names`` skips the outputs that are None."""
    table, code, wy, fx, fz, entry_idx = args[:6]
    out, CG, BH = he.blended_encode_fwd_cuda(*args)
    grads = he.blended_encode_bwd_cuda(gbar, CG, BH, code, entry_idx, wy, fx, fz,
                                       tuple(table.shape))
    torch.cuda.synchronize()
    outputs = [t for t in (out, CG, BH) + tuple(grads) if t is not None]
    return {name: digest(t) for name, t in zip(names, outputs)}


def flagship_digests(device) -> dict:
    """{output name: SHA-256} on the flagship case."""
    return kernel_digests(*flagship_inputs(device), NAMES)


def column_digests(device) -> dict:
    """{dtype: {output name: SHA-256}} on the column case."""
    return {dtype: kernel_digests(*column_inputs(device, getattr(torch, dtype)),
                                  COLUMN_NAMES)
            for dtype in COLUMN_DTYPES}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cases", nargs="+", choices=("flagship", "column"),
                        default=["flagship", "column"])
    cases = parser.parse_args(argv).cases
    if not torch.cuda.is_available():
        raise SystemExit("encode_digests needs a CUDA device")
    device = torch.device("cuda")
    result = {}
    if "flagship" in cases:
        result["digests"] = flagship_digests(device)
        torch.cuda.empty_cache()
    if "column" in cases:
        result["column_digests"] = column_digests(device)
    result["device"] = nvidia_smi()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
