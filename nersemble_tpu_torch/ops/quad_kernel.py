"""xz-quad table build and its gradient fold: the CUDA kernels B3 and B4 and
their plain PyTorch versions.

Counterpart of nersemble_tpu/ops/quad_pallas.py (``build``, ``fold``) and of
``quad_from_cast``'s custom VJP in nersemble_tpu/ops/hash_encoding.py.
``quad_build`` is the entry point, a ``torch.autograd.Function`` whose
backward is ``quad_fold``. On CPU tensors they run ``quad_build_plain`` /
``quad_fold_plain``; on CUDA tensors they launch ``csrc/quad_build.cu`` /
``csrc/quad_fold.cu`` (see the notes at the top of those files) or raise.
Both kernels are bit-exact against their plain versions.
"""

import functools
from typing import List, Tuple

import torch

from nersemble_tpu_torch.ops import cuda_lib, launch_counts
from nersemble_tpu_torch.utils import spans

N_QUARTERS = 4
MAX_LEVELS = 32  # csrc/quad_layout.cuh QUAD_MAX_LEVELS
# csrc/quad_layout.cuh QUAD_GROUP: every level offset, size and roll stride
# is a multiple of this many rows (HashGridLevels.create), so an aligned
# group of rows lies in one level and its rolled rows never wrap
ROW_GROUP = 32
MAX_ROWS = 2 ** 31 - 1


def _narrow(nbytes: int) -> bool:
    """Rows (B3) or quarters (B4) of 2, 4 or 8 bytes: the single-grid
    table's 2 features in bf16 or f32, or the one feature of a rank's
    column under the feature-sharded layout."""
    return nbytes in (2, 4, 8)


def _kernel_width(nbytes: int, ptr: int, fold: bool = False) -> bool:
    """Row (B3) or quarter (``fold``: B4) sizes the kernels take (narrow
    ones, or 16-byte chunks up to 4096 bytes), at a data pointer aligned to
    the kernel's loads: B3 reads 2-byte rows in pairs (4 bytes), B4 reads
    2-byte quarters' whole rows (16 bytes for two)."""
    if nbytes == 2:
        return ptr % (16 if fold else 4) == 0
    if _narrow(nbytes):
        return ptr % nbytes == 0
    return nbytes % 16 == 0 and 0 < nbytes <= 4096 and ptr % 16 == 0


def check_layout(levels) -> None:
    """Raise unless the kernels take ``levels``: at most ``MAX_LEVELS``
    levels, under 2^31 rows, and every level offset, size and wrapped roll
    shift a multiple of ``ROW_GROUP`` rows."""
    if levels.n_levels > MAX_LEVELS:
        raise ValueError(f"the kernels take <= {MAX_LEVELS} levels")
    if levels.total_entries > MAX_ROWS:
        raise ValueError(f"the kernels take < 2^31 rows, not {levels.total_entries}")
    meta = kernel_layout(levels)
    if any(v % ROW_GROUP for v in meta[1:]):
        raise ValueError(f"the kernels take level offsets, sizes and roll shifts "
                         f"in multiples of {ROW_GROUP} rows, not {meta[1:]}")


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


@functools.lru_cache(maxsize=64)
def _kernel_meta(levels):
    """``check_layout``, then ``kernel_layout`` as the kernels' host int64
    argument: built once per layout, not per launch."""
    check_layout(levels)
    return cuda_lib.int64_array(kernel_layout(levels))


def quad_build_cuda(table: torch.Tensor, levels) -> torch.Tensor:
    """Launch kernel B3 on a contiguous CUDA table [E, W]."""
    meta = _kernel_meta(levels)
    if not table.is_cuda:
        raise ValueError("quad_build_cuda takes a CUDA tensor")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous 2-D tensor, got {tuple(table.shape)}")
    if table.shape[0] != levels.total_entries:
        raise ValueError(f"table has {table.shape[0]} rows, the layout "
                         f"{levels.total_entries}")
    row_bytes = table.shape[1] * table.element_size()
    if not _kernel_width(row_bytes, table.data_ptr()):
        raise ValueError(f"rows of {row_bytes} B: the kernel takes rows of 2, "
                         "4 or 8 B or 16-byte chunks of rows up to 4096 B, "
                         "aligned to their loads")
    out = torch.empty(table.shape[0], N_QUARTERS * table.shape[1],
                      dtype=table.dtype, device=table.device)
    cuda_lib.run("quad_build", table.data_ptr(), out.data_ptr(), table.shape[0],
                 row_bytes, meta, torch.cuda.current_stream(table.device).cuda_stream)
    launch_counts.add("quad_build")
    if _narrow(row_bytes):
        launch_counts.add("quad_build narrow")
    return out


def quad_fold_plain(g: torch.Tensor, levels) -> torch.Tensor:
    """``_quad_bwd_xla``: [E, 4W] -> [E, W], per level the inverse rolls of
    quarters 1..3 added to quarter 0 in f32, in that order, then cast to the
    gradient dtype."""
    W = g.shape[1] // N_QUARTERS
    segs = []
    for l in range(levels.n_levels):
        off, size = levels.offsets[l], levels.sizes[l]
        seg = g[off:off + size]
        sx = levels.x_strides[l] % size
        sz = levels.z_strides[l] % size
        acc = seg[:, :W].to(torch.float32) \
            + torch.roll(seg[:, W:2 * W], sz, dims=0).to(torch.float32) \
            + torch.roll(seg[:, 2 * W:3 * W], sx, dims=0).to(torch.float32) \
            + torch.roll(seg[:, 3 * W:], (sx + sz) % size, dims=0).to(torch.float32)
        segs.append(acc.to(g.dtype))
    return torch.cat(segs, dim=0)


def quad_fold_cuda(g: torch.Tensor, levels) -> torch.Tensor:
    """Launch kernel B4 on a contiguous CUDA quad gradient [E, 4W] (bf16 or
    f32)."""
    meta = _kernel_meta(levels)
    if not g.is_cuda:
        raise ValueError("quad_fold_cuda takes a CUDA tensor")
    if g.dim() != 2 or not g.is_contiguous() or g.shape[1] % N_QUARTERS:
        raise ValueError(f"g must be a contiguous [E, 4W] tensor, got {tuple(g.shape)}")
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the fold kernel takes bf16 or f32, not {g.dtype}")
    if g.shape[0] != levels.total_entries:
        raise ValueError(f"g has {g.shape[0]} rows, the layout {levels.total_entries}")
    width = g.shape[1] // N_QUARTERS
    quarter_bytes = width * g.element_size()
    if not _kernel_width(quarter_bytes, g.data_ptr(), fold=True):
        raise ValueError(f"quarters of {quarter_bytes} B: the kernel folds "
                         "quarters of 2 (bf16), 4 or 8 B or 16-byte chunks of "
                         "quarters up to 4096 B, aligned to their loads")
    out = torch.empty(g.shape[0], width, dtype=g.dtype, device=g.device)
    cuda_lib.run("quad_fold", g.data_ptr(), out.data_ptr(), g.shape[0], quarter_bytes,
                 g.element_size(), meta, torch.cuda.current_stream(g.device).cuda_stream)
    launch_counts.add("quad_fold")
    if _narrow(quarter_bytes):
        launch_counts.add("quad_fold narrow")
    return out


def quad_fold(g: torch.Tensor, levels) -> torch.Tensor:
    """[E, 4W] quad gradient -> [E, W] canonical gradient: kernel B4 on
    CUDA, the plain version on CPU."""
    if g.device.type == "cpu":
        return quad_fold_plain(g, levels)
    return quad_fold_cuda(g, levels)


class _QuadBuild(torch.autograd.Function):
    """B3 forward, B4 backward (``quad_from_cast`` and its custom VJP)."""

    @staticmethod
    def forward(ctx, table, levels):
        ctx.levels = levels
        if table.device.type == "cpu":
            return quad_build_plain(table, levels)
        return quad_build_cuda(table, levels)

    @staticmethod
    def backward(ctx, g):
        with spans.span("bwd:quad_fold"):
            return quad_fold(g.contiguous(), ctx.levels), None


def quad_build(table: torch.Tensor, levels) -> torch.Tensor:
    """[E, W] (already cast) -> [E, 4W] quad gather operand: kernel B3 on
    CUDA, the plain version on CPU; its gradient is the fold (B4)."""
    with spans.span("encode:quad_build"):
        return _QuadBuild.apply(table, levels)
