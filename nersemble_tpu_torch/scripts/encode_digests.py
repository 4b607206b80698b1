"""SHA-256 digests of the blended encode's kernels (A3-fwd, A3-bwd) on the
flagship case: the [6,537,216, 256] bf16 quad table at 73,728 samples.

    python -m nersemble_tpu_torch.scripts.encode_digests
    PYTHONPATH=<checkout> python <this file>   # an older checkout's kernels

Prints one JSON line: the digest of each output (out, CG, BH, d_table,
d_code, d_wy, d_fx, d_fz), the card and its power limit. The inputs owe
nothing to a random generator of PyTorch: the table is an integer hash of
each element's index, the positions (half uniform, a quarter in the grid's
centre block, a quarter at the origin), the codes (the time embedding's
contrast scale) and the output gradient come from a numpy seed. Two
checkouts whose kernels sum in the same orders print the same digests;
chip_smoke.py holds the kernels to the digests of an earlier commit's. It
imports only what the port has had since its blended-encode kernels, so
the same file digests an older checkout of the package.
"""

import hashlib
import json
import math

import numpy as np
import torch

from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.ops import hash_encoding as he
from nersemble_tpu_torch.utils.cameras import CONTRAST_SCALES
from nersemble_tpu_torch.utils.timing import nvidia_smi

SEED = 0
SAMPLES = 73728   # the bench's budget
WIDTH = 256       # 32 tables x 2 features x 4 quarters
FL = 2
CODE_STD = 0.01 / math.sqrt(32)  # the time embedding's init (models/nersemble.py)
NAMES = ("out", "CG", "BH", "d_table", "d_code", "d_wy", "d_fx", "d_fz")
ROWS = 1 << 20  # rows per block when building and hashing the table


def flagship_levels():
    hc = flagship_model_config(tiny=False).hash_ensemble.hash_encoding
    return he.HashGridLevels.create(hc.n_levels, hc.log2_hashmap_size,
                                    hc.base_resolution, hc.per_level_scale)


def flagship_inputs(device):
    """(forward arguments, output gradient) of the flagship case on
    ``device``."""
    levels = flagship_levels()
    E = levels.total_entries
    table = torch.empty(E, WIDTH, dtype=torch.bfloat16, device=device)
    for lo in range(0, E, ROWS):
        hi = min(lo + ROWS, E)
        i = torch.arange(lo * WIDTH, hi * WIDTH, dtype=torch.int64, device=device)
        h = (i * 2654435761) % (1 << 32)
        table[lo:hi] = ((h.to(torch.float64) / 2 ** 32 - 0.5) * 0.6).to(
            torch.bfloat16).reshape(hi - lo, WIDTH)
    rng = np.random.default_rng(SEED)
    x = rng.uniform(size=(SAMPLES, 3)).astype(np.float32)
    q = SAMPLES // 4
    x[2 * q:3 * q] = 0.375 + 0.25 * x[2 * q:3 * q]
    x[3 * q:] = 0.0
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


def flagship_digests(device) -> dict:
    """{output name: SHA-256} of one forward and one backward of the
    kernels on the flagship case."""
    args, gbar = flagship_inputs(device)
    table, code, wy, fx, fz, entry_idx = args[:6]
    out, CG, BH = he.blended_encode_fwd_cuda(*args)
    grads = he.blended_encode_bwd_cuda(gbar, CG, BH, code, entry_idx, wy, fx, fz,
                                       tuple(table.shape))
    torch.cuda.synchronize()
    return {name: digest(t) for name, t in zip(NAMES, (out, CG, BH) + tuple(grads))}


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("encode_digests needs a CUDA device")
    result = {"digests": flagship_digests(torch.device("cuda")),
              "device": nvidia_smi()}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
