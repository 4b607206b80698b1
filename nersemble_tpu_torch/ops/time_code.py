"""The time codes' row gather on the card, whose backward is the CUDA kernel
``csrc/time_code_bwd.cu``, the plan of that kernel's tiles, and the plain
version of its sums.

``gather_rows(weight, index)`` is ``weight[index]`` for a CUDA ``weight``
[T, D] (f32): the forward is ``index_select``; the backward writes a fresh
[T, D] gradient through the kernel, which sums each row's samples in an order
that ``plan(N, T, D)`` fixes, so a step repeats bit for bit. It replaces
PyTorch's indexing backward, which sorts the indices and then walks each
distinct index's run in one warp (see the source's note). The model's CPU
path does not come here (``models/nersemble._gather_rows``).

``time_code_bwd_plain`` walks the kernel's plan in the kernel's order in
numpy, float32 op for float32 op, and gives its bits: a slow loop, for tests.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from nersemble_tpu_torch.ops import cuda_lib, launch_counts

THREADS = 256  # csrc/time_code_bwd.cu TC_THREADS
SUM_WARPS = 8  # csrc/time_code_bwd.cu TC_SUM_WARPS
MAX_WIDTH = 4 * THREADS  # a lane owns four columns: rows of at most 1024
SMEM_BYTES = 64 * 1024  # pass 1's shared memory at most (4 KB a tile row)
SMEM_LIMIT = 227 * 1024  # what an H100 block can have
MIN_PER_BLOCK = 256  # samples a block takes at least
MAX_BLOCKS = 256  # pass 1's blocks along the samples at most
MAX_PARTIAL_BYTES = 64 << 20  # the partials [blocks, T, D] f32 at most
INDEX_TYPES = (torch.int32, torch.int64)


class Plan(NamedTuple):
    """The kernel's tiles for N samples of [T, D] (csrc/time_code_bwd.cu):
    groups of ``lanes`` threads (a lane owns four columns), ``groups`` of
    them in a block; ``tiles`` of ``rows_per_tile`` rows; ``blocks`` along
    the samples, each taking ``per_block`` samples and each of its groups
    ``per_group`` of those; ``smem`` bytes of pass 1's shared memory."""
    lanes: int
    groups: int
    rows_per_tile: int
    tiles: int
    blocks: int
    per_block: int
    per_group: int
    smem: int


@functools.lru_cache(maxsize=256)
def plan(n: int, t_rows: int, d: int) -> Plan:
    """The tiles for ``n`` samples of a [t_rows, d] weight: a function of
    (n, t_rows, d) alone, so the order of every sum is too."""
    if not 1 <= d <= MAX_WIDTH:
        raise ValueError(f"the time-code kernel takes rows of 1 to {MAX_WIDTH} "
                         f"elements, not {d}")
    if n < 0 or t_rows < 0:
        raise ValueError(f"no plan for {n} samples of {t_rows} rows")
    quads = -(-d // 4)
    lanes = 1 << (quads - 1).bit_length()
    groups = THREADS // lanes
    tile_row = groups * lanes * 16  # bytes of one row in every group's tile
    rows = max(1, min(t_rows, SMEM_BYTES // tile_row))
    tiles = -(-t_rows // rows)
    blocks = per_block = 0
    if n and t_rows:
        cap = max(1, MAX_PARTIAL_BYTES // (4 * t_rows * d))
        blocks = min(-(-n // MIN_PER_BLOCK), MAX_BLOCKS, cap)
        per_block = -(-n // blocks)
        blocks = -(-n // per_block)  # no block without a sample
    if tiles > 65535:
        raise ValueError(f"the time-code kernel takes at most {65535 * rows} rows")
    return Plan(lanes, groups, rows, tiles, blocks, per_block, -(-per_block // groups),
                groups * rows * lanes * 16)


def _rows_2d(grad_out: torch.Tensor) -> torch.Tensor:
    """The gradient as [N, D] rows with unit column stride (a view where it
    can be: a column slice keeps its row stride)."""
    g = grad_out.reshape(-1, grad_out.shape[-1])
    return g if g.stride(1) == 1 or g.shape[1] == 1 else g.contiguous()


def time_code_bwd_cuda(grad_out: torch.Tensor, index: torch.Tensor,
                       t_rows: int) -> torch.Tensor:
    """The gradient [t_rows, D] f32 of ``weight[index]`` with respect to
    ``weight``, from the output's gradient ``grad_out`` [*index.shape, D]
    f32 on the card: one call, two launches on the current stream, no host
    read. Indices (int32 or int64) outside [0, t_rows) add nowhere."""
    g = _rows_2d(grad_out)
    n, d = g.shape
    device = g.device
    if device.type != "cuda" or index.device != device:
        raise ValueError(f"time_code_bwd_cuda takes CUDA tensors on one card, not "
                         f"{device} and {index.device}")
    if g.dtype != torch.float32:
        raise ValueError(f"the time-code kernel takes an f32 gradient, not {g.dtype}")
    if index.dtype not in INDEX_TYPES:
        raise ValueError(f"the time-code kernel takes int32 or int64 indices, not "
                         f"{index.dtype}")
    idx = index.reshape(-1).contiguous()
    if idx.numel() != n:
        raise ValueError(f"{idx.numel()} indices for {n} gradient rows")
    p = plan(n, t_rows, d)
    ld = g.stride(0)
    vec = d % 4 == 0 and ld % 4 == 0 and g.data_ptr() % 16 == 0
    out = torch.empty(t_rows, d, dtype=torch.float32, device=device)
    partials = torch.empty(p.blocks * t_rows * d, dtype=torch.float32, device=device)
    cuda_lib.run(
        "time_code_bwd", g.data_ptr(), ld, idx.data_ptr(), idx.element_size(), partials.data_ptr(),
        out.data_ptr(), n, t_rows, d, p.lanes, p.rows_per_tile, p.blocks, p.tiles,
        p.per_block, p.per_group, p.smem, int(vec),
        torch.cuda.current_stream(device).cuda_stream)
    launch_counts.add("time_code_bwd")
    return out


def time_code_bwd_plain(grad_out: torch.Tensor, index: torch.Tensor,
                        t_rows: int) -> torch.Tensor:
    """``time_code_bwd_cuda``'s result on the CPU, summed in the kernel's
    order: per block, row tile and group, the samples of the tile in turn,
    a run of one index summed first and then added to the group's row; the
    groups' rows in group order; the blocks in eight slices, then the
    slices."""
    g = _rows_2d(grad_out).detach().to("cpu", torch.float32).numpy()
    idx = index.reshape(-1).to("cpu", torch.int64).numpy()
    n, d = g.shape
    p = plan(n, t_rows, d)
    partials = np.zeros((p.blocks, t_rows, d), np.float32)
    for b in range(p.blocks):
        block = range(b * p.per_block, min((b + 1) * p.per_block, n))
        for first in range(0, t_rows, p.rows_per_tile):
            last = min(first + p.rows_per_tile, t_rows)
            tiles = np.zeros((p.groups, last - first, d), np.float32)
            for grp in range(p.groups):
                lo = block.start + grp * p.per_group
                mine = np.arange(lo, min(lo + p.per_group, block.stop))
                mine = mine[(idx[mine] >= first) & (idx[mine] < last)]
                cuts = np.flatnonzero(np.diff(idx[mine])) + 1
                for run in np.split(mine, cuts) if len(mine) else ():
                    acc = np.add.accumulate(g[run], axis=0)[-1]
                    tiles[grp, idx[run[0]] - first] += acc
            partials[b, first:last] = np.add.accumulate(tiles, axis=0)[-1]
    flat = partials.reshape(p.blocks, t_rows * d)
    slices = np.zeros((SUM_WARPS, t_rows * d), np.float32)
    for w in range(SUM_WARPS):
        for b in range(p.blocks * w // SUM_WARPS, p.blocks * (w + 1) // SUM_WARPS):
            slices[w] += flat[b]
    out = np.add.accumulate(slices, axis=0)[-1]
    return torch.from_numpy(out.reshape(t_rows, d).copy())


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weight, index):
        ctx.save_for_backward(index)
        ctx.t_rows = weight.shape[0]
        rows = weight.index_select(0, index.reshape(-1))
        return rows.view(*index.shape, weight.shape[1])

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        (index,) = ctx.saved_tensors
        return time_code_bwd_cuda(grad, index, ctx.t_rows), None


def gather_rows(weight: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``weight[index]`` for a [T, D] f32 weight on the card, its backward
    the time-code kernel."""
    return _GatherRows.apply(weight, index)
