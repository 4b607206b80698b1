"""What the quad kernels B3 and B4 (csrc/quad_build.cu, csrc/quad_fold.cu)
rely on, checked on the CPU: every level offset, size and roll shift of
every table layout the port builds is a multiple of 32 rows
(``quad_kernel.ROW_GROUP``), so a 32-row group lies in one level and each
quarter's rolled rows of a group are one contiguous run; the wrappers refuse
a layout without that; and the kernels' group-wise index arithmetic, run
here as torch index copies, gives the plain build and fold.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.models.field import build_levels
from nersemble_tpu_torch.ops import quad_kernel
from nersemble_tpu_torch.ops.hash_encoding import HashGridLevels

G = quad_kernel.ROW_GROUP
# the CLI tests' tiny single grid (--num-levels 4 --log2-hashmap-size 9
# --max-res 32): hashed levels of 512 rows
CLI_TINY = (4, 9, 16, float(np.exp((np.log(32) - np.log(16)) / 3)))


def _tiny_levels(variant=None):
    cfg = flagship_model_config(tiny=True)
    for edit in chip_smoke.TINY_VARIANTS.get(variant, ()):
        edit(cfg)
    return build_levels(cfg)


LAYOUTS = {
    "flagship": lambda: build_levels(flagship_model_config(tiny=False)),
    "single grid": chip_smoke.single_grid_levels,
    "tiny": _tiny_levels,
    **{f"tiny {v}": (lambda v=v: _tiny_levels(v)) for v in chip_smoke.TINY_VARIANTS},
}


def _shifts(levels):
    """[3][L] wrapped roll shifts of quarters z, x, xz."""
    return [[s % size for s, size in zip(strides, levels.sizes)]
            for strides in quad_kernel.quarter_strides(levels)]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_port_layouts_hold_the_row_group_invariant(name):
    levels = LAYOUTS[name]()
    assert all(size % 1024 == 0 for size in levels.sizes), levels.sizes
    assert all(off % G == 0 for off in levels.offsets)
    assert all(s % G == 0 for s in levels.x_strides + levels.z_strides)
    assert all(s % G == 0 for row in _shifts(levels) for s in row)
    assert levels.offsets == tuple(np.cumsum((0,) + levels.sizes[:-1]))
    quad_kernel.check_layout(levels)


def test_cli_tiny_layout_holds_the_kernels_invariant():
    """512-row hashed levels: not a multiple of 1024, but of 32 rows."""
    levels = HashGridLevels.create(*CLI_TINY)
    assert 512 in levels.sizes
    quad_kernel.check_layout(levels)


def _broken_layouts():
    tiny = HashGridLevels.create(4, 10, 4, 1.5)
    odd_stride = dataclasses.replace(
        tiny, x_strides=tuple(s + 16 for s in tiny.x_strides))
    odd_size = dataclasses.replace(
        tiny, sizes=tiny.sizes[:-1] + (tiny.sizes[-1] - 16,),
        total_entries=tiny.total_entries - 16)
    too_deep = HashGridLevels.create(33, 10, 4, 1.05)
    return {"stride": odd_stride, "size": odd_size, "levels": too_deep}


@pytest.mark.parametrize("what", ["stride", "size", "levels"])
def test_wrappers_refuse_layouts_without_the_invariant(what):
    levels = _broken_layouts()[what]
    table = torch.zeros(levels.total_entries, 2, dtype=torch.bfloat16)
    grad = torch.zeros(levels.total_entries, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="levels|multiples"):
        quad_kernel.check_layout(levels)
    with pytest.raises(ValueError, match="levels|multiples"):
        quad_kernel.quad_build_cuda(table, levels)
    with pytest.raises(ValueError, match="levels|multiples"):
        quad_kernel.quad_fold_cuda(grad, levels)


def _groups(levels):
    """(first row, level) of every 32-row group, as a warp finds it: the
    count of level offsets at or below the row, less one."""
    offsets = np.array(levels.offsets)
    for row0 in range(0, levels.total_entries, G):
        yield row0, int((offsets <= row0).sum()) - 1


def _source_major_build(table, levels):
    """quad_build_tma_kernel's stores: each 32-row group of source rows
    copied whole into quarter q of the output rows off + (r - off - s_q)
    mod size, one contiguous run of 32."""
    E, W = table.shape
    out = torch.full((E, 4 * W), float("nan"), dtype=table.dtype)
    shifts = _shifts(levels)
    for row0, l in _groups(levels):
        off, size = levels.offsets[l], levels.sizes[l]
        for q in range(4):
            o = row0 if q == 0 else off + (row0 - off - shifts[q - 1][l]) % size
            assert off <= o and o + G <= off + size  # a run inside the level
            out[o:o + G, q * W:(q + 1) * W] = table[row0:row0 + G]
    return out


def _narrow_build(table, levels):
    """quad_build_narrow_kernel's loads: per group, each quarter's source
    rows are the run rolled_forward(row0) .. + 31."""
    E, W = table.shape
    parts = [table]
    shifts = _shifts(levels)
    for q in range(1, 4):
        index = torch.empty(E, dtype=torch.long)
        for row0, l in _groups(levels):
            off, size = levels.offsets[l], levels.sizes[l]
            src = off + (row0 - off + shifts[q - 1][l]) % size
            assert src + G <= off + size
            index[row0:row0 + G] = torch.arange(src, src + G)
        parts.append(table[index])
    return torch.cat(parts, dim=1)


def _group_fold(g, levels):
    """quad_fold_narrow_kernel's loads: per group, quarter q comes from the
    run rolled_back(row0) .. + 31; summed in f32 in quarter order."""
    E, W4 = g.shape
    W = W4 // 4
    acc = g[:, :W].to(torch.float32)
    shifts = _shifts(levels)
    for q in range(1, 4):
        index = torch.empty(E, dtype=torch.long)
        for row0, l in _groups(levels):
            off, size = levels.offsets[l], levels.sizes[l]
            src = off + (row0 - off - shifts[q - 1][l]) % size
            assert src + G <= off + size
            index[row0:row0 + G] = torch.arange(src, src + G)
        acc = acc + g[index, q * W:(q + 1) * W].to(torch.float32)
    return acc.to(g.dtype)


@pytest.mark.parametrize("layout,width,dtype", [
    ((4, 10, 4, 1.5), 2, torch.bfloat16),    # tiny: 1024-row hashed levels
    ((4, 10, 4, 1.5), 2, torch.float32),
    (CLI_TINY, 2, torch.bfloat16),           # 512-row hashed levels
    ((6, 12, 4, 1.5), 64, torch.bfloat16),   # padded dense + hashed, flagship width
    ((6, 12, 4, 1.5), 16, torch.float32),
])
def test_group_arithmetic_gives_the_plain_build_and_fold(layout, width, dtype):
    levels = HashGridLevels.create(*layout)
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.normal(size=(levels.total_entries, width))
                             .astype(np.float32)).to(dtype)
    grad = torch.from_numpy(rng.normal(size=(levels.total_entries, 4 * width))
                            .astype(np.float32)).to(dtype)
    plain = quad_kernel.quad_build_plain(table, levels)
    assert torch.equal(_source_major_build(table, levels), plain)
    assert torch.equal(_narrow_build(table, levels), plain)
    assert torch.equal(_group_fold(grad, levels), quad_kernel.quad_fold_plain(grad, levels))
