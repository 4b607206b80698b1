"""xz-quad table build: the CUDA kernel B3 and its plain PyTorch version.

Counterpart of nersemble_tpu/ops/quad_pallas.py::build (the fold kernel
comes with training). ``quad_build`` is the entry point: on a CPU tensor it
runs ``quad_build_plain``; on a CUDA tensor it launches
``csrc/quad_build.cu`` (see the note at the top of that file) or raises.
The kernel is a copy, so its output is bit-exact against the plain version.
"""

from typing import List, Tuple

import torch

from nersemble_tpu_torch.ops import cuda_lib

N_QUARTERS = 4
MAX_LEVELS = 32  # csrc/quad_build.cu QB_MAX_LEVELS

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def quarter_strides(levels) -> List[Tuple[int, ...]]:
    """Per-level roll strides of quarters 1..3 (z, x, x+z); quarter 0 is the
    entry itself."""
    xz = tuple(x + z for x, z in zip(levels.x_strides, levels.z_strides))
    return [levels.z_strides, levels.x_strides, xz]


def quad_build_plain(table: torch.Tensor, levels) -> torch.Tensor:
    """[E, W] -> [E, 4W] with per-level ``torch.roll`` + ``cat``."""
    quarters = [table]
    for strides in quarter_strides(levels):
        segs = []
        for l in range(levels.n_levels):
            off, size = levels.offsets[l], levels.sizes[l]
            segs.append(torch.roll(table[off:off + size],
                                   -(strides[l] % size), dims=0))
        quarters.append(torch.cat(segs, dim=0))
    return torch.cat(quarters, dim=1)


def kernel_layout(levels) -> List[int]:
    """The kernel's layout argument: [n_levels, offsets, sizes, then the
    wrapped shifts (stride mod size) of quarters z, x, xz per level]."""
    shifts = [s % size for strides in quarter_strides(levels)
              for s, size in zip(strides, levels.sizes)]
    return [levels.n_levels, *levels.offsets, *levels.sizes, *shifts]


def quad_build_cuda(table: torch.Tensor, levels) -> torch.Tensor:
    """Launch kernel B3 on a contiguous CUDA table [E, W]."""
    global LAUNCHES
    if not table.is_cuda:
        raise ValueError("quad_build_cuda takes a CUDA tensor")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous 2-D tensor, got {tuple(table.shape)}")
    if table.shape[0] != levels.total_entries:
        raise ValueError(f"table has {table.shape[0]} rows, the layout "
                         f"{levels.total_entries}")
    if levels.n_levels > MAX_LEVELS:
        raise ValueError(f"the kernel takes <= {MAX_LEVELS} levels")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16 or row_bytes > 4096:
        raise ValueError(f"rows of {row_bytes} B: the kernel copies 16-byte "
                         "chunks of rows up to 4096 B")
    meta = cuda_lib.int64_array(kernel_layout(levels))
    out = torch.empty(table.shape[0], N_QUARTERS * table.shape[1],
                      dtype=table.dtype, device=table.device)
    status = cuda_lib.library().quad_build(
        table.data_ptr(), out.data_ptr(), table.shape[0], row_bytes, meta,
        torch.cuda.current_stream(table.device).cuda_stream)
    cuda_lib.check(status, "quad_build")
    LAUNCHES += 1
    return out


def quad_build(table: torch.Tensor, levels) -> torch.Tensor:
    """[E, W] (already cast) -> [E, 4W] quad gather operand: kernel B3 on
    CUDA, the plain version on CPU."""
    if table.device.type == "cpu":
        return quad_build_plain(table, levels)
    return quad_build_cuda(table, levels)
