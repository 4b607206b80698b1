"""Multiresolution hash-grid encoding (port of
nersemble_tpu/ops/hash_encoding.py).

The layout is the JAX package's, kept exactly so checkpoints interchange:
levels indexed densely where the grid fits (``idx = y + SX*x + SZ*z``) and
by an additive hash otherwise (``(y*p1 + x*SX + z*SZ) mod 2^M``), so both
the x+1 and z+1 neighbours of a vertex are a fixed per-level stride away.
The xz-quad table [E, 4W] packs each entry with its z-, x- and
xz-successors, so one gathered row serves four cell corners (the module
docstring of the JAX file has the full design).

The blended encode is plain PyTorch here: gather the rows as
[N, 2 corners, L, 4 quarters, H tables, F_l], then sum over tables,
quarters and corners. The JAX version rounds ``rows * code`` to the table
dtype before its f32 sum; this does the same (the product is taken in the
table dtype). Its backward is JAX's analytic one (``_BlendedEncode``); the
hand kernel for both directions is ROADMAP A3. The single-grid field's
plain encode (``hash_encode``) is the same function without the blend.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch.profiler import record_function

from nersemble_tpu_torch.ops.quad_kernel import N_QUARTERS, quad_build
from nersemble_tpu_torch.utils.device import device_constant

_PRIMES = (2654435761, 805459861, 3674653429)
# Dense level sizes are padded to multiples of this many rows. It was the
# TPU quad kernel's block size (nersemble_tpu/ops/quad_pallas.py BLOCK) and
# is part of the table layout now; the CUDA kernel has no block constraint.
LAYOUT_BLOCK = 2048


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


class _BlendedEncode(torch.autograd.Function):
    """``_blended_core`` with the analytic backward of ``_blended_vjp_bwd``.

    The forward keeps two residuals in the table dtype, as JAX does:
    CG [n,2,L,4,Fl] (the code-blended quarters) and BH [n,L,H,Fl] (the
    weight-blended rows, corners and quarters folded). The backward rounds
    to the table dtype where JAX does (gbar before the BH product; the row
    gradient ``wy * u * gbar`` and its product with the code) and gives the
    gradients of the quad table, the code and the weights wy, fx, fz (which
    autograd carries on to the positions through ``hash_grid_indices``).

    The table gradient is scattered into an f32 [E, 4W] accumulator and cast
    to the table dtype once. JAX accumulates its dense prefix in f32 too,
    but its hashed levels in the table dtype (a bf16 add per scattered row):
    bf16 accumulation saturates on hot entries (ROADMAP C4), which this
    avoids; at bf16 the two differ by a few bf16 ulps on hashed entries that
    receive several rows (tests/test_torch_train_encode.py states the bound).
    """

    @staticmethod
    def forward(ctx, quad_table, code, wy, fx, fz, entry_idx, n_levels,
                features_per_logical, keep_residuals):
        n, L, Fl = wy.shape[0], n_levels, features_per_logical
        W = quad_table.shape[1] // N_QUARTERS
        H = W // Fl
        dt = quad_table.dtype
        rows = quad_table[entry_idx.reshape(-1)].view(n, 2, L, N_QUARTERS, H, Fl)
        if code is None:  # the plain encode: one table, no blend
            cg = rows[:, :, :, :, 0].to(torch.float32)  # [n,2,L,4,Fl]
        else:
            # per-logical-table blend, product rounded to the table dtype as in JAX
            code_t = code.to(dt)[:, None, None, None, :, None]
            cg = torch.sum(rows * code_t, dim=4, dtype=torch.float32)  # [n,2,L,4,Fl]
        u = _quad_weights(fx, fz)  # [n,L,4]
        g = torch.sum(cg * u[:, None, :, :, None], dim=3)  # [n,2,L,Fl]
        out = g[:, 0] * wy[:, :L, None] + g[:, 1] * wy[:, L:, None]
        if keep_residuals:
            bh = None
            if code is not None:
                wu = (wy.view(n, 2, L)[..., None] * u[:, None]).to(dt)  # [n,2,L,4]
                b = rows[:, 0] * wu[:, 0, :, :, None, None] \
                    + rows[:, 1] * wu[:, 1, :, :, None, None]  # [n,L,4,H,Fl] dt
                bh = torch.sum(b, dim=2, dtype=torch.float32).to(dt)  # [n,L,H,Fl]
            ctx.save_for_backward(cg.to(dt), bh, code, entry_idx, wy, fx, fz)
            ctx.table_shape = quad_table.shape
            ctx.layout = (L, Fl)
        return out.reshape(n, L * Fl)

    @staticmethod
    @record_function("bwd:hash_encode")
    def backward(ctx, gbar):
        CG, BH, code, entry_idx, wy, fx, fz = ctx.saved_tensors
        L, Fl = ctx.layout
        E, W4 = ctx.table_shape
        n, dt = wy.shape[0], CG.dtype
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
        # d rows = (gbar * u * wy) rounded, times the rounded code
        m = (gbar * u5 * w5).to(dt)  # [n,2,L,4,Fl]
        d_code, d_rows = None, m
        if code is not None:
            # d code[h] = sum_{l,f} BH[l,h,f] * gbar[l,f], product in the table dtype
            gb = gbar.reshape(n, L, 1, Fl).to(dt)
            d_code = torch.sum(BH * gb, dim=(1, 3), dtype=torch.float32)
            d_rows = m[:, :, :, :, None, :] \
                * code.to(dt)[:, None, None, None, :, None]
        acc = torch.zeros(E, W4, dtype=torch.float32, device=CG.device)
        acc.index_add_(0, entry_idx.reshape(-1),
                       d_rows.reshape(-1, W4).to(torch.float32))
        return (acc.to(dt), d_code, d_wy, d_fx, d_fz, None, None, None, None)


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
