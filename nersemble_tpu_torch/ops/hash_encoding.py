"""Multiresolution hash-grid encoding (port of
nersemble_tpu/ops/hash_encoding.py).

The layout is the JAX package's, kept exactly so checkpoints interchange:
levels indexed densely where the grid fits (``idx = y + SX*x + SZ*z``) and
by an additive hash otherwise (``(y*p1 + x*SX + z*SZ) mod 2^M``), so both
the x+1 and z+1 neighbours of a vertex are a fixed per-level stride away.
The xz-quad table [E, 4W] packs each entry with its z-, x- and
xz-successors, so one gathered row serves four cell corners (the module
docstring of the JAX file has the full design).

The blended encode gathers the rows as [N, 2 corners, L, 4 quarters, H
tables, F_l], then sums over tables, quarters and corners. The JAX version
rounds ``rows * code`` to the table dtype before its f32 sum; this does the
same (the product is taken in the table dtype). Its backward is JAX's
analytic one (``_BlendedEncode``). On CUDA tensors both directions run the
hand kernels A3-fwd / A3-bwd (``csrc/blended_encode.cu``; the backward's
table gradient in a fixed order, without atomics), on CPU tensors their
plain versions (``blended_encode_fwd_plain`` / ``_bwd_plain``). The
single-grid field's plain encode (``hash_encode``) is the same function
without the blend. On quad rows of 4 elements A3-bwd orders the keys with
its own counting sort; ``column_table_grad_plain`` repeats that order's
arithmetic on the CPU.
"""

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from nersemble_tpu_torch.ops import cuda_lib, launch_counts
from nersemble_tpu_torch.ops.quad_kernel import N_QUARTERS, quad_build
from nersemble_tpu_torch.utils import spans
from nersemble_tpu_torch.utils.device import device_constant

_PRIMES = (2654435761, 805459861, 3674653429)
# Dense level sizes are padded to multiples of this many rows. It was the
# TPU quad kernel's block size (nersemble_tpu/ops/quad_pallas.py BLOCK) and
# is part of the table layout now; the CUDA kernel has no block constraint.
LAYOUT_BLOCK = 2048

TABLE_CHUNK = 64   # csrc/blended_encode.cu BE_CHUNK: sorted rows per chunk
# A3-bwd on quad rows of 4 elements (csrc/blended_encode.cu BE_COL_*): the
# positions per block of a counting-sort pass, the bits of a pass's digit,
# table rows per reduce block
COLUMN_BLOCK = 4096
COLUMN_DIGIT_BITS = 8
COLUMN_ROWS = 2048


@dataclass(frozen=True)
class HashGridLevels:
    """Static per-level layout (``HashGridLevels`` of the JAX package)."""

    n_levels: int
    scales: Tuple[float, ...]
    resolutions: Tuple[int, ...]
    sizes: Tuple[int, ...]
    hashed: Tuple[bool, ...]
    offsets: Tuple[int, ...]
    total_entries: int
    log2_hashmap_size: int
    x_strides: Tuple[int, ...]
    z_strides: Tuple[int, ...]

    @staticmethod
    def create(n_levels: int = 16, log2_hashmap_size: int = 19,
               base_resolution: int = 16,
               per_level_scale: float = 1.4472692012786865) -> "HashGridLevels":
        """Every size, offset and stride is a multiple of 32 rows; dense level
        sizes are padded to ``LAYOUT_BLOCK`` rows (dead rows never indexed);
        hashed levels are exactly ``2^log2_hashmap_size``."""
        align = 32
        max_size = 2 ** log2_hashmap_size
        mask = max_size - 1
        scales, resolutions, sizes, hashed, offsets = [], [], [], [], []
        sxs, szs = [], []
        offset = 0
        for l in range(n_levels):
            scale = base_resolution * per_level_scale ** l
            res = int(np.ceil(scale)) + 1
            sx = -(-res // align) * align
            sz = sx * res
            dense_size = sz * res
            if dense_size <= max_size:
                size = -(-dense_size // LAYOUT_BLOCK) * LAYOUT_BLOCK
                is_hashed = False
            else:
                size, is_hashed = max_size, True
                sx = (_PRIMES[1] & mask) & ~(align - 1)
                sz = (_PRIMES[2] & mask) & ~(align - 1)
            scales.append(float(scale))
            resolutions.append(res)
            sizes.append(size)
            hashed.append(is_hashed)
            offsets.append(offset)
            sxs.append(sx)
            szs.append(sz)
            offset += size
        return HashGridLevels(n_levels, tuple(scales), tuple(resolutions),
                              tuple(sizes), tuple(hashed), tuple(offsets),
                              offset, log2_hashmap_size, tuple(sxs),
                              tuple(szs))


def hash_grid_indices(x: torch.Tensor, levels: HashGridLevels,
                      smoothstep: bool = False):
    """Corner indices and interpolation weights for [N, 3] positions in [0,1].

    Returns (entry_idx [N, 2L] int64, wy [N, 2L], fx [N, L], fz [N, L]) in
    corner-major column order (column c * L + l is y-corner c of level l).
    All levels are computed at once as [N, L] tensors (a per-level loop
    launches hundreds of tiny kernels per call on the GPU). The JAX version
    hashes in uint32 with wraparound; here the hash is taken in int64 and
    masked, which gives the same bits (products stay < 2^43).
    """
    dev, i64 = x.device, torch.int64
    scales = device_constant(levels.scales, x.dtype, dev)
    res_max = device_constant(tuple(r - 1 for r in levels.resolutions), i64, dev)
    sx = device_constant(levels.x_strides, i64, dev)
    sz = device_constant(levels.z_strides, i64, dev)
    offsets = device_constant(levels.offsets, i64, dev)
    hashed = device_constant(levels.hashed, torch.bool, dev)
    mask = 2 ** levels.log2_hashmap_size - 1

    pos = x[:, None, :] * scales[None, :, None] + 0.5  # [N, L, 3]
    grid = torch.floor(pos)
    frac = pos - grid
    if smoothstep:
        frac = frac * frac * (3.0 - 2.0 * frac)
    grid = grid.to(torch.int64)
    cx = torch.minimum(grid[..., 0].clamp(min=0), res_max)
    cz = torch.minimum(grid[..., 2].clamp(min=0), res_max)
    idx, wy = [], []
    for c in (0, 1):
        cy = torch.minimum((grid[..., 1] + c).clamp(min=0), res_max)
        dense = cy + sx * cx + sz * cz
        hashed_idx = (cy * _PRIMES[0] + sx * cx + sz * cz) & mask
        idx.append(torch.where(hashed, hashed_idx, dense) + offsets)
        wy.append(frac[..., 1] if c else 1.0 - frac[..., 1])
    return (torch.cat(idx, dim=1), torch.cat(wy, dim=1), frac[..., 0],
            frac[..., 2])


def build_quad_table(table: torch.Tensor, levels: HashGridLevels,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[E, W] canonical -> [E, 4W] xz-quad gather operand. The cast runs
    first, so the copy moves the narrow dtype (kernel B3 on CUDA)."""
    return quad_build(table.to(dtype).contiguous(), levels)


def _quad_weights(fx: torch.Tensor, fz: torch.Tensor) -> torch.Tensor:
    """Quarter interpolation weights u_q = wx * wz, [N, L, 4]."""
    gx, gz = 1.0 - fx, 1.0 - fz
    return torch.stack([gx * gz, gx * fz, fx * gz, fx * fz], dim=-1)


def _sum_tables(terms: torch.Tensor, width: int) -> torch.Tensor:
    """The f32 sum over the table axis (-2) of ``terms`` [..., H, Fl] in
    kernel A3-fwd's order: each lane's tables (8 elements of a row of
    ``width`` per lane) left to right, then the lanes pairwise, neighbours
    first. The residual CG rounds this sum to the table dtype, so the two
    versions agree bit for bit."""
    H, Fl = terms.shape[-2:]
    per_lane = max(1, min(width, 8) // Fl)
    if H % per_lane:
        per_lane = H
    runs = terms.to(torch.float32).unflatten(-2, (H // per_lane, per_lane))
    acc = runs[..., 0, :]
    for i in range(1, per_lane):
        acc = acc + runs[..., i, :]  # [..., lanes, Fl]
    while acc.shape[-2] > 1:
        odd = acc[..., -1:, :] if acc.shape[-2] % 2 else None
        acc = acc[..., 0:acc.shape[-2] - 1:2, :] + acc[..., 1::2, :]
        if odd is not None:
            acc = torch.cat([acc, odd], dim=-2)
    return acc[..., 0, :]


def _sum_quarters(p: torch.Tensor) -> torch.Tensor:
    """The single grid's f32 sum over the quarter axis (3) of ``p``
    [n, 2, L, 4, Fl], left to right from zero, as kernel A3-fwd sums it for
    one table of 1 or 2 features: a feature's value does not depend on the
    other features of its row, so a rank's column of the feature-sharded
    single grid gives the whole table's column bit for bit."""
    acc = 0.0 + p[:, :, :, 0]
    for q in range(1, N_QUARTERS):
        acc = acc + p[:, :, :, q]
    return acc


def blended_encode_fwd_plain(quad_table, code, wy, fx, fz, entry_idx,
                             n_levels: int, features_per_logical: int,
                             keep_residuals: bool):
    """``_blended_fwd_impl`` in plain PyTorch: (out [n, L*Fl] f32, CG
    [n,2,L,4,Fl] and BH [n,L,H,Fl] in the table dtype, or None without
    residuals; BH is None without a code). The CPU path, and kernel A3-fwd's
    reference on the card."""
    n, L, Fl = wy.shape[0], n_levels, features_per_logical
    W = quad_table.shape[1] // N_QUARTERS
    H = W // Fl
    dt = quad_table.dtype
    rows = quad_table[entry_idx.reshape(-1)].view(n, 2, L, N_QUARTERS, H, Fl)
    u = _quad_weights(fx, fz)  # [n,L,4]
    if code is None:  # the plain encode: one table, no blend
        cg = rows[:, :, :, :, 0].to(torch.float32)  # [n,2,L,4,Fl]
        g = _sum_quarters(cg * u[:, None, :, :, None])  # [n,2,L,Fl]
    else:
        # per-logical-table blend, product rounded to the table dtype as in JAX
        code_t = code.to(dt)[:, None, None, None, :, None]
        cg = _sum_tables(rows * code_t, W)  # [n,2,L,4,Fl]
        g = torch.sum(cg * u[:, None, :, :, None], dim=3)  # [n,2,L,Fl]
    out = g[:, 0] * wy[:, :L, None] + g[:, 1] * wy[:, L:, None]
    CG = bh = None
    if keep_residuals:
        if code is not None:
            wu = (wy.view(n, 2, L)[..., None] * u[:, None]).to(dt)  # [n,2,L,4]
            b = rows[:, 0] * wu[:, 0, :, :, None, None] \
                + rows[:, 1] * wu[:, 1, :, :, None, None]  # [n,L,4,H,Fl] dt
            b = b.to(torch.float32)  # quarters (q0 + q1) + (q2 + q3), as A3-fwd
            bh = ((b[:, :, 0] + b[:, :, 1]) + (b[:, :, 2] + b[:, :, 3])).to(dt)  # [n,L,H,Fl]
        CG = cg.to(dt)
    return out.reshape(n, L * Fl), CG, bh


def _row_gradients(gbar, code, wy, fx, fz, dtype):
    """The gradient of every gathered row, [n, 2, L, 4, (H,) Fl] in
    ``dtype``: (gbar * u * wy) rounded, times the rounded code."""
    n, L = fx.shape
    Fl = gbar.numel() // (n * L)
    u5 = _quad_weights(fx, fz)[:, None, :, :, None]  # [n,1,L,4,1]
    w5 = wy.view(n, 2, L)[:, :, :, None, None]  # [n,2,L,1,1]
    d_rows = (gbar.to(torch.float32).reshape(n, 1, L, 1, Fl) * u5 * w5).to(dtype)
    if code is None:
        return d_rows
    return d_rows[:, :, :, :, None, :] * code.to(dtype)[:, None, None, None, :, None]


def blended_encode_bwd_plain(gbar, CG, BH, code, entry_idx, wy, fx, fz,
                             table_shape, need_table: bool = True):
    """``_blended_vjp_bwd`` in plain PyTorch: (d quad table [E, 4W] in the
    table dtype, or None unless ``need_table``; d code [n, H] or None; d wy
    [n, 2L], d fx, d fz [n, L]). The table gradient is scattered into an f32
    accumulator with ``index_add_`` (atomics, in no fixed order on the card)
    and cast once. The CPU path, and kernel A3-bwd's reference on the
    card."""
    n, _, L, _, Fl = CG.shape
    E, W4 = table_shape
    dt = CG.dtype
    gbar = gbar.to(torch.float32).reshape(n, 1, L, 1, Fl)
    cg = CG.to(torch.float32)
    u = _quad_weights(fx, fz)
    u5 = u[:, None, :, :, None]  # [n,1,L,4,1]
    w5 = wy.view(n, 2, L)[:, :, :, None, None]  # [n,2,L,1,1]

    d_wy = torch.sum(cg * u5 * gbar, dim=(3, 4)).reshape(n, 2 * L)
    core = cg * w5 * gbar  # [n,2,L,4,Fl]
    gx, gz = 1.0 - fx, 1.0 - fz
    pat_fx = torch.stack([-gz, -fz, gz, fz], dim=-1)[:, None, :, :, None]
    pat_fz = torch.stack([-gx, gx, -fx, fx], dim=-1)[:, None, :, :, None]
    d_fx = torch.sum(core * pat_fx, dim=(1, 3, 4))
    d_fz = torch.sum(core * pat_fz, dim=(1, 3, 4))
    d_code = None
    if code is not None:
        # d code[h] = sum_{l,f} BH[l,h,f] * gbar[l,f], product in the table dtype
        gb = gbar.reshape(n, L, 1, Fl).to(dt)
        d_code = torch.sum(BH * gb, dim=(1, 3), dtype=torch.float32)
    if not need_table:
        return None, d_code, d_wy, d_fx, d_fz
    d_rows = _row_gradients(gbar, code, wy, fx, fz, dt)
    acc = torch.zeros(E, W4, dtype=torch.float32, device=CG.device)
    acc.index_add_(0, entry_idx.reshape(-1),
                   d_rows.reshape(-1, W4).to(torch.float32))
    return acc.to(dt), d_code, d_wy, d_fx, d_fz


def column_passes(n_rows: int):
    """The digits of A3-bwd's counting sort of the keys on quad rows of 4
    elements (csrc/blended_encode.cu be_col_plan): [(first bit, bits, digit
    values)], 8 bits each, the last what is left of the bits of
    ``n_rows - 1``; a digit takes only the values keys below ``n_rows``
    give."""
    bits = max(1, (n_rows - 1).bit_length())
    passes, at = [], 0
    while at < bits:
        width = min(bits - at, COLUMN_DIGIT_BITS)
        passes.append((at, width, min(1 << width, ((n_rows - 1) >> at) + 1)))
        at += width
    return passes


def _rank_in_group(group: torch.Tensor) -> torch.Tensor:
    """Per element, the count of elements before it with the same group."""
    order = torch.sort(group, stable=True)[1]
    sorted_group = group[order]
    start = torch.ones_like(sorted_group, dtype=torch.bool)
    start[1:] = sorted_group[1:] != sorted_group[:-1]
    at = torch.arange(group.numel(), device=group.device)
    first = torch.cummax(torch.where(start, at, torch.zeros_like(at)), 0)[0]
    rank = torch.empty_like(at)
    rank[order] = at - first
    return rank


def column_pass_slots(keys: torch.Tensor, lo: int, width: int, values: int) -> torch.Tensor:
    """One pass of the counting sort (be_col_count / colscan / scatter
    kernels): each position's slot = its digit's start (the digit totals
    scanned) + the counts of that digit in earlier blocks of
    ``COLUMN_BLOCK`` positions + the equal digits before it in its block
    (the kernel's warp counts and ballot ranks add up to this). Integer
    counts: the same slots in any order of counting."""
    T = keys.numel()
    digit = (keys.long() >> lo) & ((1 << width) - 1)
    block = torch.arange(T, device=keys.device) // COLUMN_BLOCK
    n_blocks = -(-T // COLUMN_BLOCK)
    counts = torch.bincount(block * values + digit, minlength=n_blocks * values)
    counts = counts.view(n_blocks, values)
    before_block = counts.cumsum(0) - counts
    total = counts.sum(0)
    start = total.cumsum(0) - total
    return start[digit] + before_block[block, digit] + _rank_in_group(block * values + digit)


def column_order_plain(keys: torch.Tensor, n_rows: int):
    """A3-bwd's order of the positions on quad rows of 4 elements:
    (positions in sorted order [T] int64, their keys [T]) from the passes
    of ``column_passes``, least significant digit first. Equals a stable
    sort of the keys."""
    perm = torch.arange(keys.numel(), device=keys.device)
    skey = keys.reshape(-1).long()
    for lo, width, values in column_passes(n_rows):
        slot = column_pass_slots(skey, lo, width, values)
        nxt_perm, nxt_key = torch.empty_like(perm), torch.empty_like(skey)
        nxt_perm[slot] = perm
        nxt_key[slot] = skey
        perm, skey = nxt_perm, nxt_key
    return perm, skey


def column_ranges(skey: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The sorted positions of each reduce block's ``COLUMN_ROWS`` rows:
    [blocks + 1] starts (the first position of a key at or past each
    block's first row, as be_col_starts_kernel marks them)."""
    firsts = torch.arange(0, n_rows + COLUMN_ROWS, COLUMN_ROWS, device=skey.device)
    return torch.searchsorted(skey, firsts.clamp(max=n_rows))


def column_pieces(skey: torch.Tensor) -> torch.Tensor:
    """Whether each sorted position starts a piece: a new key, or a
    multiple of ``TABLE_CHUNK`` (the chunk walk's cuts)."""
    at = torch.arange(skey.numel(), device=skey.device)
    start = at % TABLE_CHUNK == 0
    start[1:] |= skey[1:] != skey[:-1]
    return start


def column_table_grad_plain(gbar, entry_idx, wy, fx, fz, table_shape, dtype):
    """A3-bwd's table gradient on quad rows of 4 elements in the kernel's
    arithmetic: each position's factor round((gbar * u_q) * wy), the
    positions in ``column_order_plain``'s order, each piece summed left to
    right in f32 from zero, the pieces of a key added in order, rounded
    once; rows no key reaches zero. Bit for bit what the kernels give."""
    E, W4 = table_shape
    fac = _row_gradients(gbar, None, wy, fx, fz, dtype).reshape(-1, W4).float()
    perm, skey = column_order_plain(entry_idx.reshape(-1), E)
    fac = fac[perm]
    out = torch.zeros(E, W4, dtype=dtype, device=fac.device)
    if skey.numel() == 0:
        return out
    starts = column_pieces(skey)
    first = torch.nonzero(starts).reshape(-1)
    length = torch.diff(first, append=torch.tensor([skey.numel()], device=first.device))
    acc = torch.zeros(first.numel(), W4, dtype=torch.float32, device=fac.device)
    for t in range(int(length.max())):
        live = length > t
        acc[live] = acc[live] + fac[first[live] + t]
    # the pieces of a key in order: the first, then each next one added
    pkey = skey[first]
    run_start = torch.ones_like(pkey, dtype=torch.bool)
    run_start[1:] = pkey[1:] != pkey[:-1]
    run_first = torch.nonzero(run_start).reshape(-1)
    n_pieces = torch.diff(run_first, append=torch.tensor([pkey.numel()],
                                                          device=first.device))
    total = acc[run_first].clone()
    for t in range(1, int(n_pieces.max())):
        live = n_pieces > t
        total[live] = total[live] + acc[run_first[live] + t]
    out[pkey[run_first]] = total.to(dtype)
    return out


# kernel A3 against its plain version (chip_smoke.py, the card tests): the
# outputs, the residuals and the per-sample gradients are the plain
# version's roundings with the f32 sums in another order
MAX_ERR_REL = 2.0 ** -9  # of max |plain|
MEAN_ERR_REL = 1e-5      # of mean |plain|
_MANTISSA_BITS = {torch.bfloat16: 8, torch.float32: 24}


def compare_to_plain(ours, refs, names) -> Dict[str, Dict[str, float]]:
    """Per named tensor: max abs error (also relative to max |plain|) and
    mean abs error against the plain version's, with their limits; raises
    AssertionError when a limit is exceeded. None pairs are skipped."""
    out = {}
    for name, a, b in zip(names, ours, refs):
        if a is None and b is None:
            continue
        err = (a.float() - b.float()).abs()
        scale = float(b.float().abs().max())
        res = {"max_abs": float(err.max()),
               "max_rel": float(err.max()) / scale if scale else 0.0,
               "max_tol": MAX_ERR_REL * scale,
               "mean_abs": float(err.mean()),
               "mean_tol": MEAN_ERR_REL * float(b.float().abs().mean())}
        if not (res["max_abs"] <= res["max_tol"] and res["mean_abs"] <= res["mean_tol"]):
            raise AssertionError(f"blended encode {name} differs from its plain "
                                 f"version: {res}")
        out[name] = res
    return out


def table_grad_mass(gbar, code, entry_idx, wy, fx, fz, table_shape, dtype):
    """Per table-gradient row and entry: (the rows of the n*2L that reach it
    [E] int64, the f32 sum of the |row gradient| values reaching it [E, 4W]):
    the scale of the error of an f32 sum of those rows in another order."""
    E, W4 = table_shape
    flat = entry_idx.reshape(-1)
    rows = _row_gradients(gbar, code, wy, fx, fz, dtype)
    mass = torch.zeros(E, W4, dtype=torch.float32, device=flat.device)
    mass.index_add_(0, flat, rows.reshape(-1, W4).to(torch.float32).abs())
    return torch.bincount(flat, minlength=E), mass


def compare_table_grads(ours: torch.Tensor, ref: torch.Tensor, count: torch.Tensor,
                        mass: torch.Tensor, rows: int = 1 << 20) -> Dict[str, float]:
    """The table gradient against the plain version's: both sum each
    entry's k rows in f32 (in other orders) and round once to the table
    dtype, so an entry may differ by one table-dtype ulp (at the larger
    magnitude of the two) plus twice the f32 error bound of a k-term sum in
    any order, k * 2^-24 * sum |row| each (``table_grad_mass``); past one
    ulp only where the rows cancel. Returns the unequal entries, the
    largest distance in ulps and the largest share of the bound; raises
    past the bound."""
    bits = _MANTISSA_BITS[ref.dtype]
    unequal, past_ulp, worst_ulps, worst_share = 0, 0, 0.0, 0.0
    for lo in range(0, ref.shape[0], rows):
        a, b = ours[lo:lo + rows].float(), ref[lo:lo + rows].float()
        _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
        ulp = torch.ldexp(torch.ones_like(a), exp - bits)
        diff = (a - b).abs()
        reorder = 2.0 ** -23 * count[lo:lo + rows, None].float() * mass[lo:lo + rows]
        unequal += int((diff > 0).sum())
        past_ulp += int((diff > ulp).sum())
        worst_ulps = max(worst_ulps, float((diff / ulp).max()))
        worst_share = max(worst_share, float((diff / (ulp + reorder)).max()))
    res = {"unequal": unequal, "past_one_ulp": past_ulp, "max_ulps": worst_ulps,
           "max_share": worst_share, "entries": ref.numel()}
    if worst_share > 1.0:
        raise AssertionError(f"blended encode table gradient past its bound "
                             f"against its plain version: {res}")
    return res


def _ptr(x):
    return None if x is None else x.data_ptr()


def _kernel_shape(quad_table, code, n_levels: int, features_per_logical: int):
    """(W, H) of a quad table that kernels A3-fwd / A3-bwd take; raises,
    naming the shape, on one they lack."""
    E, W4 = quad_table.shape
    Fl, W = features_per_logical, W4 // N_QUARTERS
    H = W // Fl if Fl else 0
    ok = (quad_table.dtype in (torch.bfloat16, torch.float32)
          and quad_table.is_contiguous() and quad_table.data_ptr() % 16 == 0
          and W4 == N_QUARTERS * W and 0 < W4 <= 1024 and E < 2 ** 31
          and (W4 % 8 == 0 or (code is None and W4 == N_QUARTERS))
          and Fl in (1, 2, 4, 8) and H * Fl == W
          and (code is not None or H == 1)
          and (code is None or tuple(code.shape) == (code.shape[0], H)))
    if not ok:
        raise ValueError(
            f"blended encode kernel: no variant for a {quad_table.dtype} quad "
            f"table {tuple(quad_table.shape)} with {Fl} features per table"
            + ("" if code is None else f" and a code {tuple(code.shape)}")
            + "; it takes bf16 or f32 rows of whole 8-element chunks up to "
              "4W = 1024 elements, 1, 2, 4 or 8 features per table, and "
              "without a code one table of 1, 2, 4 or 8 features (a row of "
              "4 elements: the single grid's column of one feature)")
    return W, H


def blended_encode_fwd_cuda(quad_table, code, wy, fx, fz, entry_idx,
                            n_levels: int, features_per_logical: int,
                            keep_residuals: bool):
    """Kernel A3-fwd on CUDA tensors; returns what
    ``blended_encode_fwd_plain`` returns."""
    if not quad_table.is_cuda:
        raise ValueError("blended_encode_fwd_cuda takes CUDA tensors")
    W, H = _kernel_shape(quad_table, code, n_levels, features_per_logical)
    n, L, Fl, dt = wy.shape[0], n_levels, features_per_logical, quad_table.dtype
    out = torch.empty(n, L * Fl, dtype=torch.float32, device=wy.device)
    CG = BH = None
    if keep_residuals:
        CG = torch.empty(n, 2, L, N_QUARTERS, Fl, dtype=dt, device=wy.device)
        if code is not None:
            BH = torch.empty(n, L, H, Fl, dtype=dt, device=wy.device)
    if n == 0:
        return out, CG, BH
    cuda_lib.run(
        "blended_encode_fwd", quad_table.data_ptr(), entry_idx.data_ptr(),
        wy.data_ptr(), fx.data_ptr(), fz.data_ptr(), _ptr(code), out.data_ptr(),
        _ptr(CG), _ptr(BH), n, L, H, W, Fl, quad_table.element_size(),
        torch.cuda.current_stream(wy.device).cuda_stream)
    launch_counts.add("blended_encode_fwd")
    if W == 1:
        launch_counts.add("blended_encode_fwd narrow")
    return out, CG, BH


def _scratch_widths(features_per_logical: int, n_tables: int, elem_bytes: int):
    """(MP, HP): A3-bwd's scratch rows in elements, the row factor [4, Fl]
    and the rounded code [H], each padded to whole 16-byte vectors
    (csrc/blended_encode.cu be_pad)."""
    per = 16 // elem_bytes
    return (-(-N_QUARTERS * features_per_logical // per) * per,
            -(-n_tables // per) * per)


class BlendedBwdPlan:
    """One A3-bwd call: its outputs, its scratch and its parts, each a
    launch on the current stream. ``blended_encode_bwd_cuda`` runs them in
    turn; chip_smoke.py times each part alone (``parts``).

    The parts: ``zero`` (the table gradient, rows no sample reached),
    ``sort`` (the entry indices as int32 keys, a stable ``torch.sort``:
    index preparation), ``sample`` (the per-sample gradients, each
    position's rounded row factor and the rounded code rows), ``chunks``
    (runs inside chunks of ``TABLE_CHUNK`` sorted positions) and ``spans``
    (runs across chunks); the last two need the first three. On quad rows
    of 4 elements (W = 1) the table takes two parts and no zeroing:
    ``order`` (the counting sort's passes: keys and rounded factors into
    the scratch) and ``reduce`` (every row of the table gradient), after
    ``sample`` (the per-sample gradients, and the rounded factors into the
    scratch)."""

    def __init__(self, gbar, CG, BH, code, entry_idx, wy, fx, fz, table_shape,
                 need_table: bool = True):
        n, _, L, _, Fl = CG.shape
        E, W4 = table_shape
        dt, dev = CG.dtype, CG.device
        W = W4 // N_QUARTERS
        H = W // Fl
        if code is not None and BH is None:
            raise ValueError("the blended encode's backward needs its BH residual")
        f32 = dict(dtype=torch.float32, device=dev)
        self.n, self.L, self.H, self.W, self.Fl = n, L, H, W, Fl
        self.inputs = (gbar.to(torch.float32).contiguous(), CG, BH, code, entry_idx,
                       wy, fx, fz)
        self.d_code = None if code is None else torch.empty(n, H, **f32)
        self.d_wy = torch.empty(n, 2 * L, **f32)
        self.d_fx, self.d_fz = torch.empty(n, L, **f32), torch.empty(n, L, **f32)
        self.d_table = self.mfac = self.coder = self.partial = None
        self.skey = self.perm = self.scratch = None
        if need_table and W == 1:
            self.d_table = torch.empty(E, W4, dtype=dt, device=dev)
            size = cuda_lib.library().blended_encode_bwd_column_scratch(
                n, L, E, CG.element_size())
            if size < 0:
                raise ValueError(f"blended encode column backward: no plan for {n} "
                                 f"samples, {L} levels and {E} rows")
            self.scratch = torch.empty(size, dtype=torch.uint8, device=dev)
        elif need_table:
            self.d_table = torch.empty(E, W4, dtype=dt, device=dev)
            mp, hp = _scratch_widths(Fl, H, CG.element_size())
            self.mfac = torch.empty(n * 2 * L, mp, dtype=dt, device=dev)
            if code is not None:
                self.coder = torch.empty(n, hp, dtype=dt, device=dev)
            chunks = -(-(n * 2 * L) // TABLE_CHUNK)
            self.partial = torch.empty(2 * chunks, W4, **f32)

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.inputs[1].device).cuda_stream

    def _shape(self):
        return (self.n, self.L, self.H, self.W, self.Fl, self.inputs[1].element_size())

    def zero(self) -> None:
        d = self.d_table
        cuda_lib.run("blended_encode_zero", d.data_ptr(), d.numel() * d.element_size(),
                     self._stream())

    def sort(self) -> None:
        flat = self.inputs[4].reshape(-1).to(torch.int32)
        self.skey, self.perm = torch.sort(flat, stable=True)

    def sample(self) -> None:
        gbar, CG, BH, code, _, wy, fx, fz = self.inputs
        cuda_lib.run(
            "blended_encode_bwd_sample", gbar.data_ptr(), CG.data_ptr(), _ptr(BH),
            _ptr(code), wy.data_ptr(), fx.data_ptr(), fz.data_ptr(), _ptr(self.mfac),
            _ptr(self.coder), _ptr(self.d_code), self.d_wy.data_ptr(),
            self.d_fx.data_ptr(), self.d_fz.data_ptr(), *self._shape(), self._stream())

    def chunks(self) -> None:
        cuda_lib.run(
            "blended_encode_bwd_chunks", self.skey.data_ptr(), self.perm.data_ptr(),
            self.mfac.data_ptr(), _ptr(self.coder), self.d_table.data_ptr(),
            self.partial.data_ptr(), *self._shape(), self._stream())

    def spans(self) -> None:
        n, L, _, W, _, es = self._shape()
        cuda_lib.run("blended_encode_bwd_spans", self.skey.data_ptr(),
                     self.partial.data_ptr(), self.d_table.data_ptr(), n, L, W, es,
                     self._stream())

    def column(self, parts: int = 7) -> None:
        """On quad rows of 4 elements, the parts given as a sum: 4 ``sample``
        (with the rounded factors), 1 ``order``, 2 ``reduce``; 7 all three
        in one call."""
        gbar, CG, _, _, entry_idx, wy, fx, fz = self.inputs
        cuda_lib.run(
            "blended_encode_bwd_column", gbar.data_ptr(), CG.data_ptr(),
            entry_idx.data_ptr(), wy.data_ptr(), fx.data_ptr(), fz.data_ptr(),
            self.d_wy.data_ptr(), self.d_fx.data_ptr(), self.d_fz.data_ptr(),
            self.d_table.data_ptr(), self.scratch.data_ptr(), self.n, self.L,
            self.d_table.shape[0], CG.element_size(), parts, self._stream())

    def parts(self) -> Dict[str, object]:
        """{name: the part as a call on the current stream}; run in this
        order they give the wrapper's outputs (the wrapper writes the zeros
        first)."""
        if self.scratch is not None:
            return {"sample": lambda: self.column(4), "order": lambda: self.column(1),
                    "reduce": lambda: self.column(2)}
        return {"sort": self.sort, "sample": self.sample, "memset": self.zero,
                "chunk": self.chunks, "span": self.spans}

    def outputs(self):
        return self.d_table, self.d_code, self.d_wy, self.d_fx, self.d_fz


def blended_encode_bwd_cuda(gbar, CG, BH, code, entry_idx, wy, fx, fz,
                            table_shape, need_table: bool = True):
    """Kernel A3-bwd on CUDA tensors; returns what
    ``blended_encode_bwd_plain`` returns. The table gradient is summed per
    row in f32 in a fixed order (the stable sort of the entry indices) and
    rounded once: bit for bit from run to run. Every part runs on the
    current stream (``BlendedBwdPlan``): the zeros, the sort, the per-sample
    kernel, then the table's kernels. Quad rows of 4 elements take the
    kernels' own counting sort, which writes every row."""
    if not CG.is_cuda:
        raise ValueError("blended_encode_bwd_cuda takes CUDA tensors")
    plan = BlendedBwdPlan(gbar, CG, BH, code, entry_idx, wy, fx, fz, table_shape,
                          need_table)
    if plan.n == 0:
        if need_table:
            plan.d_table.zero_()
        return plan.outputs()
    if need_table and plan.scratch is not None:
        plan.column()
    elif need_table:
        plan.zero()
        plan.sort()
        plan.sample()
        plan.chunks()
        plan.spans()
    else:
        plan.sample()
    launch_counts.add("blended_encode_bwd")
    if plan.W == 1:
        launch_counts.add("blended_encode_bwd narrow")
    return plan.outputs()


class _BlendedEncode(torch.autograd.Function):
    """``_blended_core`` with the analytic backward of ``_blended_vjp_bwd``:
    kernels A3-fwd / A3-bwd on CUDA tensors, their plain versions on CPU
    tensors.

    The forward keeps two residuals in the table dtype, as JAX does:
    CG [n,2,L,4,Fl] (the code-blended quarters) and BH [n,L,H,Fl] (the
    weight-blended rows, corners and quarters folded). The backward rounds
    to the table dtype where JAX does (gbar before the BH product; the row
    gradient ``wy * u * gbar`` and its product with the code) and gives the
    gradients of the quad table, the code and the weights wy, fx, fz (which
    autograd carries on to the positions through ``hash_grid_indices``).

    The table gradient sums every row's contributions in f32 and casts to
    the table dtype once. JAX accumulates its dense prefix in f32 too,
    but its hashed levels in the table dtype (a bf16 add per scattered row):
    bf16 accumulation saturates on hot entries (ROADMAP C4), which this
    avoids; at bf16 the two differ by a few bf16 ulps on hashed entries that
    receive several rows (tests/test_torch_train_encode.py states the bound).
    On the card A3-bwd sums each row in one fixed order (ROADMAP C11).
    """

    @staticmethod
    def forward(ctx, quad_table, code, wy, fx, fz, entry_idx, n_levels,
                features_per_logical, keep_residuals):
        with spans.span("encode:fwd"):
            if quad_table.device.type == "cpu":
                out, CG, BH = blended_encode_fwd_plain(
                    quad_table, code, wy, fx, fz, entry_idx, n_levels,
                    features_per_logical, keep_residuals)
            else:
                wy, fx, fz = wy.contiguous(), fx.contiguous(), fz.contiguous()
                code = None if code is None else code.contiguous()
                out, CG, BH = blended_encode_fwd_cuda(
                    quad_table, code, wy, fx, fz, entry_idx.contiguous(),
                    n_levels, features_per_logical, keep_residuals)
        if keep_residuals:
            ctx.save_for_backward(CG, BH, code, entry_idx, wy, fx, fz)
            ctx.table_shape = tuple(quad_table.shape)
        return out

    @staticmethod
    def backward(ctx, gbar):
        CG, BH, code, entry_idx, wy, fx, fz = ctx.saved_tensors
        need_table = ctx.needs_input_grad[0]
        bwd = blended_encode_bwd_plain if CG.device.type == "cpu" \
            else blended_encode_bwd_cuda
        with spans.span("bwd:hash_encode"):
            d_table, d_code, d_wy, d_fx, d_fz = bwd(
                gbar, CG, BH, code, entry_idx, wy, fx, fz, ctx.table_shape,
                need_table)
        return (d_table, d_code, d_wy, d_fx, d_fz, None, None, None, None)


def hash_encode_blended(quad_table: torch.Tensor, x: torch.Tensor,
                        code: torch.Tensor, levels: HashGridLevels,
                        features_per_logical: int = 2,
                        smoothstep: bool = False) -> torch.Tensor:
    """Ensemble encode + per-sample blend -> [N, L * F_l] float32:

        out[n, l*Fl+f] = sum_{corner,h} w[n,l,corner] * code[n,h]
                         * table[idx[n,l,corner], h*Fl + f]

    Differentiable in the quad table, the code and ``x`` (analytic
    backward, no re-gather; see ``_BlendedEncode``).
    """
    entry_idx, wy, fx, fz = hash_grid_indices(x, levels, smoothstep)
    code = code.to(torch.float32)
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (quad_table, code, wy, fx, fz))
    return _BlendedEncode.apply(quad_table, code, wy, fx, fz, entry_idx,
                                levels.n_levels, features_per_logical, keep)


def hash_encode(quad_table: torch.Tensor, x: torch.Tensor,
                levels: HashGridLevels) -> torch.Tensor:
    """Plain single-grid encode: quad table [E, 4W], x [N, 3] -> [N, L * W]
    float32, level-major (tcnn's layout for W = features per level).

    ``_BlendedEncode`` with no code: the same gathered rows, quarter and
    corner weights and analytic backward, without the blend. JAX's
    ``hash_encode`` differentiates through its gather instead; both round
    the row gradient ``wy * u * gbar`` to the table dtype, and the port adds
    the rows in f32 as for the blended encode.
    """
    entry_idx, wy, fx, fz = hash_grid_indices(x, levels)
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (quad_table, wy, fx, fz))
    return _BlendedEncode.apply(quad_table, None, wy, fx, fz, entry_idx,
                                levels.n_levels,
                                quad_table.shape[1] // N_QUARTERS, keep)
