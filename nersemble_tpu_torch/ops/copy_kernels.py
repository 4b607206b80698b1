"""The measurement path's copy kernels: the row gather (P1) and the quad
build's cost ladder (P2 copy, P3 broadcast-quarters, P4 seven-fetch), each
with its plain PyTorch version and a launch counter.

Counterparts of the Pallas kernels of scripts/pallas_gather_probe.py
(``make_pallas_gather``) and scripts/bench_quad_build.py
(``run_diagnostics``: ``copy_kernel``, ``bcast_kernel``, ``fetch7_kernel``).
Each kernel has two functions: ``*_cuda`` launches ``csrc/gather_rows.cu``
/ ``csrc/copy_ladder.cu`` (see the notes at the top of those files) on CUDA
tensors and raises on any other, and ``*_plain`` is the same function in
plain PyTorch. All four are copies: each kernel is bit-exact against its
plain version.

``block`` stands for the Pallas ``BlockSpec`` block of the ladder, rows
per work unit: a thread block's rows in P3 and P4, a unit of P2's grid
stride; the default is the JAX package's 2048 rows.
"""

import torch

from nersemble_tpu_torch.ops import cuda_lib

N_QUARTERS = 4
BLOCK = 2048                  # rows per thread block (the Pallas block)
DEPTHS = (8, 16, 32, 64)      # the gather probe's sweep
DEFAULT_DEPTH = 32            # make_pallas_gather's default
MAX_GATHER_ROW_BYTES = 256    # csrc/gather_rows.cu GR_MAX_CHUNKS * 16

GATHER_LAUNCHES = 0  # P1 launches since the last reset (chip_smoke.py reads them)
COPY_LAUNCHES = 0    # P2
BCAST_LAUNCHES = 0   # P3
FETCH7_LAUNCHES = 0  # P4


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rows(name: str, x: torch.Tensor) -> int:
    """Raise unless ``x`` is a contiguous 2-D CUDA tensor of bf16 or f32
    rows that are a multiple of 16 bytes; returns the row bytes."""
    if not x.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous 2-D tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} takes bf16 or f32, not {x.dtype}")
    row_bytes = x.shape[1] * x.element_size()
    if row_bytes == 0 or row_bytes % 16:
        raise ValueError(f"{name}: rows of {row_bytes} B; the kernel moves "
                         "16-byte chunks")
    return row_bytes


def _check_block(block: int) -> None:
    if block < 1:
        raise ValueError(f"block must be >= 1 rows, got {block}")


# -- P1: row gather -------------------------------------------------------------

def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]]: ``index_select`` on the row axis."""
    return table.index_select(0, idx)


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor,
                     depth: int = DEFAULT_DEPTH) -> torch.Tensor:
    """Launch kernel P1: [E, W] table (bf16 or f32, rows of at most 256 B),
    [N] int32 or int64 indices -> [N, W]. ``depth`` (8, 16, 32 or 64) is the
    number of row reads each warp keeps in flight. The indices are not
    range-checked on the device (that would need a synchronizing read):
    an index outside [0, E) reads outside the table."""
    global GATHER_LAUNCHES
    row_bytes = _check_rows("gather_rows_cuda", table)
    if row_bytes > MAX_GATHER_ROW_BYTES:
        raise ValueError(f"gather_rows_cuda: rows of {row_bytes} B; the kernel "
                         f"takes rows of at most {MAX_GATHER_ROW_BYTES} B")
    if idx.dim() != 1 or not idx.is_contiguous() or idx.device != table.device:
        raise ValueError("idx must be a contiguous 1-D tensor on the table's device")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be int32 or int64, not {idx.dtype}")
    if depth not in DEPTHS:
        raise ValueError(f"depth must be one of {DEPTHS}, got {depth}")
    out = torch.empty(idx.shape[0], table.shape[1], dtype=table.dtype,
                      device=table.device)
    status = cuda_lib.library().gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
        row_bytes, idx.element_size(), depth, _stream(table))
    cuda_lib.check(status, "gather_rows")
    GATHER_LAUNCHES += 1
    return out


# -- P2: copy -------------------------------------------------------------------

def copy_plain(x: torch.Tensor) -> torch.Tensor:
    """out = x, as the Pallas body writes it: a new tensor assigned whole."""
    out = torch.empty_like(x)
    out[...] = x
    return out


def copy_cuda(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Launch kernel P2 on a contiguous CUDA [E, W] tensor."""
    global COPY_LAUNCHES
    row_bytes = _check_rows("copy_cuda", x)
    _check_block(block)
    out = torch.empty_like(x)
    status = cuda_lib.library().ladder_copy(
        x.data_ptr(), out.data_ptr(), x.shape[0], row_bytes, block, _stream(x))
    cuda_lib.check(status, "ladder_copy")
    COPY_LAUNCHES += 1
    return out


# -- P3: broadcast to four quarters ---------------------------------------------

def bcast_quarters_plain(x: torch.Tensor) -> torch.Tensor:
    """[E, W] -> [E, 4W] with out[:, qW:(q+1)W] = x for q = 0..3."""
    W = x.shape[1]
    out = torch.empty(x.shape[0], N_QUARTERS * W, dtype=x.dtype, device=x.device)
    for q in range(N_QUARTERS):
        out[:, q * W:(q + 1) * W] = x
    return out


def bcast_quarters_cuda(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Launch kernel P3 on a contiguous CUDA [E, W] tensor."""
    global BCAST_LAUNCHES
    row_bytes = _check_rows("bcast_quarters_cuda", x)
    _check_block(block)
    out = torch.empty(x.shape[0], N_QUARTERS * x.shape[1], dtype=x.dtype,
                      device=x.device)
    status = cuda_lib.library().ladder_bcast(
        x.data_ptr(), out.data_ptr(), x.shape[0], row_bytes, block, _stream(x))
    cuda_lib.check(status, "ladder_bcast")
    BCAST_LAUNCHES += 1
    return out


# -- P4: seven fetches, four quarters written -------------------------------------

def _check_seven(refs) -> None:
    if len(refs) != 7:
        raise ValueError(f"fetch7 takes seven inputs, got {len(refs)}")
    first = refs[0]
    for r in refs[1:]:
        if r.shape != first.shape or r.dtype != first.dtype or r.device != first.device:
            raise ValueError("fetch7's seven inputs must share shape, dtype "
                             "and device")


def fetch7_plain(*refs: torch.Tensor) -> torch.Tensor:
    """Seven [E, W] inputs -> [E, 4W] = [r0 | r1 | r3 | r5]."""
    _check_seven(refs)
    W = refs[0].shape[1]
    out = torch.empty(refs[0].shape[0], N_QUARTERS * W, dtype=refs[0].dtype,
                      device=refs[0].device)
    out[:, 0:W] = refs[0]
    for q in range(1, N_QUARTERS):
        out[:, q * W:(q + 1) * W] = refs[2 * q - 1]
    return out


def fetch7_cuda(*refs: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Launch kernel P4: all seven inputs are read, four are written."""
    global FETCH7_LAUNCHES
    _check_seven(refs)
    row_bytes = _check_rows("fetch7_cuda", refs[0])
    for r in refs[1:]:
        _check_rows("fetch7_cuda", r)
    _check_block(block)
    x = refs[0]
    out = torch.empty(x.shape[0], N_QUARTERS * x.shape[1], dtype=x.dtype,
                      device=x.device)
    status = cuda_lib.library().ladder_fetch7(
        *(r.data_ptr() for r in refs), out.data_ptr(), x.shape[0], row_bytes,
        block, _stream(x))
    cuda_lib.check(status, "ladder_fetch7")
    FETCH7_LAUNCHES += 1
    return out


def reset_counts() -> None:
    """Set the four launch counters to 0."""
    global GATHER_LAUNCHES, COPY_LAUNCHES, BCAST_LAUNCHES, FETCH7_LAUNCHES
    GATHER_LAUNCHES = COPY_LAUNCHES = BCAST_LAUNCHES = FETCH7_LAUNCHES = 0


def counts() -> dict:
    """The four launch counters by kernel name."""
    return {"gather_rows": GATHER_LAUNCHES, "copy": COPY_LAUNCHES,
            "bcast_quarters": BCAST_LAUNCHES, "fetch7": FETCH7_LAUNCHES}
