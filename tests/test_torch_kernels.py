"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU or interpret mode, so every test here needs a GPU
and nvcc, and skips without them (the decision is made inside the fixture,
never at import). On the card: ``python -m pytest -m cuda tests/``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke

from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.models.nersemble import NeRSembleModel
from nersemble_tpu_torch.ops import copy_kernels
from nersemble_tpu_torch.ops import fused_mlp as tfm
from nersemble_tpu_torch.ops import quad_kernel
from nersemble_tpu_torch.ops.hash_encoding import HashGridLevels
from nersemble_tpu_torch.ops.mlp import init_mlp
from nersemble_tpu_torch.utils.cameras import add_contrast
from nersemble_tpu_torch.utils.params import ParamTree

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


MLP_SHAPES = [
    # (in, out, layers, width, skips, bias, out_act)
    (32, 16, 2, 64, (), False, None),           # density base
    (18, 3, 3, 64, (), False, "sigmoid"),       # colour head
    (173, 128, 6, 128, (4,), True, "relu"),     # flagship deformation stem
    (61, 16, 2, 16, (), True, "relu"),          # tiny stem
    (45 + 16, 32, 6, 32, (4,), True, "relu"),   # narrow stem with a skip
    # the colour head's other input widths: SH degree 4 (16 + 15), the
    # appearance embedding (3 + 15 + 32), both (16 + 15 + 32)
    (31, 3, 3, 64, (), False, "sigmoid"),
    (50, 3, 3, 64, (), False, "sigmoid"),
    (63, 3, 3, 64, (), False, "sigmoid"),
]


@pytest.mark.parametrize("d_in,d_out,n_layers,width,skips,bias,out_act",
                         MLP_SHAPES)
# B1-fwd takes 64-row blocks, two to a 128-row tile, one persistent block
# per SM: 1 and 63 rows are one ragged block, 64 one whole block (bulk-copied
# x), 65 a whole and a ragged one, 191 / 193 one and a half tiles, 1000 and
# 4096 fewer tiles than SMs
@pytest.mark.parametrize("rows", [1, 63, 64, 65, 191, 193, 1000, 4096])
def test_fused_mlp_kernel_matches_plain(cuda, d_in, d_out, n_layers, width,
                                        skips, bias, out_act, rows):
    g = torch.Generator(device=cuda).manual_seed(0)
    params = ParamTree(init_mlp(g, d_in, d_out, n_layers, width, skips, bias))
    x = torch.randn(rows, d_in, generator=g, device=cuda)
    before = tfm.LAUNCHES
    out = tfm.fused_mlp_apply(params, x, out_act, torch.bfloat16, skips)
    torch.cuda.synchronize()
    assert tfm.LAUNCHES == before + 1
    ref = tfm.fused_mlp_plain(params, x, out_act, torch.bfloat16, skips)
    assert out.shape == (rows, d_out) and out.dtype == torch.float32
    tfm.compare_to_plain(out, ref)  # the tolerance stated in ops/fused_mlp.py


@pytest.mark.parametrize("rows", [73728, 98304 + 17])
def test_fused_mlp_kernel_stem_at_chunk_sizes(cuda, rows):
    """The flagship stem at the train step's budget and past the chunk cap
    with a ragged block: many tiles per block of the persistent grid, the
    weight ring cycling through every stage."""
    g = torch.Generator(device=cuda).manual_seed(13)
    params = ParamTree(init_mlp(g, 173, 128, 6, 128, (4,), True))
    x = torch.randn(rows, 173, generator=g, device=cuda)
    out = tfm.fused_mlp_cuda(params, x, "relu", (4,))
    tfm.compare_to_plain(out, tfm.fused_mlp_plain(params, x, "relu",
                                                  torch.bfloat16, (4,)))


@pytest.mark.parametrize("d_in,d_out,n_layers,width,skips,bias,out_act",
                         [MLP_SHAPES[1], MLP_SHAPES[2]])
@pytest.mark.parametrize("rows", [65, 5000])
def test_fused_mlp_kernel_takes_misaligned_x(cuda, d_in, d_out, n_layers, width,
                                             skips, bias, out_act, rows):
    """x = big[1:] starts 72 or 692 bytes into its storage, not on 16
    bytes: the kernel reads it without bulk copies, bit for bit as it reads
    an aligned copy through them. On ``positive_`` weights and inputs: at 65
    random rows one hidden activation rounded to its neighbouring bf16 value
    can exceed the mean bound on its own (the earlier mma.sync kernel's
    outputs differ from the plain version's by the same amount on such
    inputs)."""
    g = torch.Generator(device=cuda).manual_seed(14)
    params = tfm.positive_(ParamTree(init_mlp(g, d_in, d_out, n_layers, width,
                                              skips, bias)), g)
    big = tfm.positive_input(rows + 1, d_in, g)
    x = big[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    out = tfm.fused_mlp_cuda(params, x, out_act, skips)
    assert torch.equal(out, tfm.fused_mlp_cuda(params, x.clone(), out_act, skips))
    tfm.compare_to_plain(out, tfm.fused_mlp_plain(params, x, out_act,
                                                  torch.bfloat16, skips))


@pytest.mark.parametrize("d_in,d_out,n_layers,width,skips,bias,out_act",
                         MLP_SHAPES[:3])
def test_fused_mlp_kernel_is_deterministic(cuda, d_in, d_out, n_layers, width,
                                           skips, bias, out_act):
    """Two B1-fwd launches at 98,304 rows give bitwise-equal outputs."""
    g = torch.Generator(device=cuda).manual_seed(15)
    params = ParamTree(init_mlp(g, d_in, d_out, n_layers, width, skips, bias))
    x = torch.randn(98304, d_in, generator=g, device=cuda)
    first = tfm.fused_mlp_cuda(params, x, out_act, skips)
    assert torch.equal(first, tfm.fused_mlp_cuda(params, x, out_act, skips))


@pytest.mark.parametrize("d_in,d_out,bias,out_act", [
    (32, 16, True, None), (18, 64, False, "relu"), (173, 128, True, "sigmoid"),
    (21, 100, False, None)])  # a width the kernel runs padded to 128
@pytest.mark.parametrize("rows", [1, 65, 4096])
def test_fused_mlp_kernel_one_layer(cuda, d_in, d_out, bias, out_act, rows):
    """A single layer of each wgmma width: one product from the x tile,
    where a transposed fragment or descriptor shows at 1 and 65 rows."""
    g = torch.Generator(device=cuda).manual_seed(16)
    params = ParamTree(init_mlp(g, d_in, d_out, 1, d_out, (), bias))
    x = torch.randn(rows, d_in, generator=g, device=cuda)
    out = tfm.fused_mlp_cuda(params, x, out_act)
    tfm.compare_to_plain(out, tfm.fused_mlp_plain(params, x, out_act, torch.bfloat16))


@pytest.mark.parametrize("d_in,d_out,n_layers,width,skips,bias,out_act",
                         MLP_SHAPES)
@pytest.mark.parametrize("rows", [1, 65, 1000, 4096, 98303, 98304])
def test_fused_mlp_bwd_kernel_matches_plain(cuda, d_in, d_out, n_layers, width,
                                            skips, bias, out_act, rows):
    """B2 against fused_mlp_bwd_plain within ops/fused_mlp.py's stated
    bounds (compare_bwd_to_plain), for dx, every dW and every db, on
    positive_ weights and inputs (no relu sign depends on rounding, no sum
    cancels)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    params = tfm.positive_(ParamTree(init_mlp(g, d_in, d_out, n_layers, width,
                                              skips, bias)), g)
    x = tfm.positive_input(rows, d_in, g)
    gy = tfm.positive_input(rows, d_out, g)
    before = tfm.BWD_LAUNCHES
    out = tfm.fused_mlp_bwd_cuda(params, x, gy, out_act, skips)
    torch.cuda.synchronize()
    assert tfm.BWD_LAUNCHES == before + 1
    ref = tfm.fused_mlp_bwd_plain(params, x, gy, out_act, torch.bfloat16, skips)
    assert out[0].shape == (rows, d_in)
    assert [tuple(w.shape) for w in out[1]] == [tuple(w.shape) for w in ref[1]]
    tfm.compare_bwd_to_plain(out, ref)


@pytest.mark.parametrize("d_in,d_out,n_layers,width,skips,bias,out_act",
                         MLP_SHAPES[:3])
@pytest.mark.parametrize("rows", [65, 98304])
def test_fused_mlp_bwd_kernel_is_deterministic(cuda, d_in, d_out, n_layers, width,
                                               skips, bias, out_act, rows):
    """Two B2 launches on the same inputs give bitwise-equal dx, dW and db
    (per-block partials summed in a fixed order, no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    params = tfm.positive_(ParamTree(init_mlp(g, d_in, d_out, n_layers, width,
                                              skips, bias)), g)
    x = tfm.positive_input(rows, d_in, g)
    gy = tfm.positive_input(rows, d_out, g)
    first = tfm.fused_mlp_bwd_cuda(params, x, gy, out_act, skips)
    second = tfm.fused_mlp_bwd_cuda(params, x, gy, out_act, skips)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert all(torch.equal(a, b) for a, b in zip(first[1], second[1]))
    assert all(torch.equal(a, b) for a, b in zip(first[2] or (), second[2] or ()))


def test_fused_mlp_autograd_launches_both_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    params = tfm.positive_(ParamTree(init_mlp(g, 173, 128, 6, 128, (4,), True)), g)
    for p in params.parameters():
        p.requires_grad_(True)
    x = tfm.positive_input(3000, 173, g).requires_grad_(True)
    gy = tfm.positive_input(3000, 128, g)
    before = (tfm.LAUNCHES, tfm.BWD_LAUNCHES)
    out = tfm.fused_mlp_apply(params, x, "relu", torch.bfloat16, (4,))
    out.backward(gy)
    torch.cuda.synchronize()
    assert (tfm.LAUNCHES, tfm.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref = tfm.fused_mlp_bwd_plain(params, x.detach(), gy, "relu",
                                  torch.bfloat16, (4,))
    layers = params.layers
    tfm.compare_bwd_to_plain((x.grad, [l.w.grad for l in layers],
                              [l.b.grad for l in layers]), ref)


def test_fused_mlp_kernel_rejects_bad_inputs(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    params = ParamTree(init_mlp(g, 32, 16, 2, 64, (), False))
    x = torch.randn(64, 32, device=cuda)
    with pytest.raises(ValueError):
        tfm.fused_mlp_apply(params, x.t().contiguous().t())  # non-contiguous
    with pytest.raises(ValueError):
        tfm.fused_mlp_apply(params, x.half())
    with pytest.raises(ValueError):
        tfm.fused_mlp_apply(params, x, compute_dtype=torch.float32)


@pytest.mark.parametrize("layout,width,dtype", [
    ((6, 12, 4, 1.5), 8, torch.bfloat16),   # padded dense + 2048-row hashed
    ((4, 10, 4, 1.5), 16, torch.bfloat16),  # tiny: 1024-row hashed levels
    ((4, 10, 4, 1.5), 16, torch.float32),
    ((16, 19, 16, 1.4472692012786865), 8, torch.bfloat16),  # flagship levels
])
def test_quad_build_kernel_is_bit_exact(cuda, layout, width, dtype):
    levels = HashGridLevels.create(*layout)
    g = torch.Generator(device=cuda).manual_seed(1)
    table = torch.randn(levels.total_entries, width, generator=g,
                        device=cuda).to(dtype)
    before = quad_kernel.LAUNCHES
    out = quad_kernel.quad_build(table, levels)
    torch.cuda.synchronize()
    assert quad_kernel.LAUNCHES == before + 1
    assert torch.equal(out, quad_kernel.quad_build_plain(table, levels))


@pytest.mark.parametrize("layout,width,dtype", [
    ((6, 12, 4, 1.5), 8, torch.bfloat16),   # padded dense + 2048-row hashed
    ((4, 10, 4, 1.5), 16, torch.bfloat16),  # tiny: 1024-row hashed levels
    ((4, 10, 4, 1.5), 16, torch.float32),
    ((16, 19, 16, 1.4472692012786865), 64, torch.bfloat16),  # flagship
])
def test_quad_fold_kernel_is_bit_exact(cuda, layout, width, dtype):
    levels = HashGridLevels.create(*layout)
    g = torch.Generator(device=cuda).manual_seed(4)
    grad = torch.randn(levels.total_entries, 4 * width, generator=g,
                       device=cuda).to(dtype)
    before = quad_kernel.FOLD_LAUNCHES
    out = quad_kernel.quad_fold(grad, levels)
    torch.cuda.synchronize()
    assert quad_kernel.FOLD_LAUNCHES == before + 1
    assert out.shape == (levels.total_entries, width) and out.dtype == dtype
    assert torch.equal(out, quad_kernel.quad_fold_plain(grad, levels))


SINGLE_GRID = (16, 19, 16, float(np.exp((np.log(2048) - np.log(16)) / 15)))


@pytest.mark.parametrize("layout,dtype", [
    ((4, 10, 4, 1.5), torch.bfloat16),   # 1024-row hashed levels: ragged
    ((4, 10, 4, 1.5), torch.float32),
    ((6, 12, 4, 1.5), torch.float32),    # padded dense + 2048-row hashed
    (SINGLE_GRID, torch.bfloat16),       # the single-grid field's table
])
def test_quad_kernels_take_narrow_rows(cuda, layout, dtype):
    """B3 on [E, 2] tables (rows of 4 B in bf16, 8 B in f32) and B4 on
    their [E, 8] gradients, bit-exact against the plain versions."""
    levels = HashGridLevels.create(*layout)
    g = torch.Generator(device=cuda).manual_seed(5)
    table = torch.randn(levels.total_entries, 2, generator=g,
                        device=cuda).to(dtype)
    grad = torch.randn(levels.total_entries, 8, generator=g,
                       device=cuda).to(dtype)
    before = (quad_kernel.LAUNCHES, quad_kernel.FOLD_LAUNCHES)
    out = quad_kernel.quad_build(table, levels)
    folded = quad_kernel.quad_fold(grad, levels)
    torch.cuda.synchronize()
    assert (quad_kernel.LAUNCHES, quad_kernel.FOLD_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(out, quad_kernel.quad_build_plain(table, levels))
    assert torch.equal(folded, quad_kernel.quad_fold_plain(grad, levels))


FLAGSHIP = (16, 19, 16, 1.4472692012786865)


def _quad_layout(name):
    """The card tests' level layouts: ragged 1024-row hashed levels, padded
    dense levels, 512-row hashed levels (the CLI tests' tiny single grid),
    the single grid, the flagship, and the flagship with every roll stride
    0 (each quarter of a row is the row itself)."""
    if name == "flagship no rolls":
        lv = HashGridLevels.create(*FLAGSHIP)
        return dataclasses.replace(lv, x_strides=(0,) * lv.n_levels,
                                   z_strides=(0,) * lv.n_levels)
    return HashGridLevels.create(*{
        "tiny": (4, 10, 4, 1.5), "padded": (6, 12, 4, 1.5),
        "cli tiny": (4, 9, 16, float(np.exp((np.log(32) - np.log(16)) / 3))),
        "single grid": SINGLE_GRID, "flagship": FLAGSHIP}[name])


# every row width the wrapper routes differently (narrow 4 and 8 B, the
# output-major 16-64 B rows, the source-major 128 and 512 B rows) on the
# small layouts; the full-size ones up to 128 B (a 512 B flagship table and
# its plain build would take tens of GB)
QUAD_WIDTH_CASES = [(layout, row_bytes)
                    for layout in ("tiny", "padded", "cli tiny", "single grid",
                                   "flagship", "flagship no rolls")
                    for row_bytes in (4, 8, 16, 32, 64, 128, 512)
                    if row_bytes <= 128 or layout in ("tiny", "padded", "cli tiny")]


@pytest.mark.parametrize("layout,row_bytes", QUAD_WIDTH_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quad_kernels_at_every_width(cuda, layout, dtype, row_bytes):
    """B3 on rows of each width and B4 on quarters of the same widths,
    bit-exact against the plain versions, with their launch counters."""
    levels = _quad_layout(layout)
    width = row_bytes // torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device=cuda).manual_seed(row_bytes)
    table = torch.randn(levels.total_entries, width, generator=g,
                        device=cuda).to(dtype)
    before = (quad_kernel.LAUNCHES, quad_kernel.FOLD_LAUNCHES,
              quad_kernel.NARROW_LAUNCHES, quad_kernel.NARROW_FOLD_LAUNCHES)
    out = quad_kernel.quad_build(table, levels)
    torch.cuda.synchronize()
    assert torch.equal(out, quad_kernel.quad_build_plain(table, levels))
    del out, table
    grad = torch.randn(levels.total_entries, 4 * width, generator=g,
                       device=cuda).to(dtype)
    folded = quad_kernel.quad_fold(grad, levels)
    torch.cuda.synchronize()
    assert torch.equal(folded, quad_kernel.quad_fold_plain(grad, levels))
    narrow = row_bytes in (4, 8)
    assert (quad_kernel.LAUNCHES, quad_kernel.FOLD_LAUNCHES,
            quad_kernel.NARROW_LAUNCHES, quad_kernel.NARROW_FOLD_LAUNCHES) == \
        (before[0] + 1, before[1] + 1, before[2] + narrow, before[3] + narrow)


@pytest.mark.parametrize("layout", ["tiny", "padded", "cli tiny", "single grid",
                                    "flagship no rolls"])
def test_quad_kernels_on_two_byte_rows(cuda, layout):
    """One bf16 feature per row: the single grid's column under the
    feature-sharded layout. B3 on 2-byte rows and B4 on 2-byte quarters,
    bit-exact, counted as narrow launches; on the single grid also the
    tables of 1 feature that a rank holds in f32 (4-byte rows)."""
    levels = _quad_layout(layout)
    g = torch.Generator(device=cuda).manual_seed(2)
    table = torch.randn(levels.total_entries, 1, generator=g, device=cuda).to(torch.bfloat16)
    grad = torch.randn(levels.total_entries, 4, generator=g, device=cuda).to(torch.bfloat16)
    before = (quad_kernel.NARROW_LAUNCHES, quad_kernel.NARROW_FOLD_LAUNCHES)
    out, folded = quad_kernel.quad_build(table, levels), quad_kernel.quad_fold(grad, levels)
    torch.cuda.synchronize()
    assert (quad_kernel.NARROW_LAUNCHES, quad_kernel.NARROW_FOLD_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(out, quad_kernel.quad_build_plain(table, levels))
    assert torch.equal(folded, quad_kernel.quad_fold_plain(grad, levels))
    if layout == "single grid":
        table = table.float()
        grad = grad.float()
        assert torch.equal(quad_kernel.quad_build(table, levels),
                           quad_kernel.quad_build_plain(table, levels))
        assert torch.equal(quad_kernel.quad_fold(grad, levels),
                           quad_kernel.quad_fold_plain(grad, levels))


def test_quad_kernels_refuse_a_layout_off_the_row_groups(cuda):
    levels = HashGridLevels.create(4, 10, 4, 1.5)
    odd = dataclasses.replace(levels, x_strides=tuple(s + 16 for s in levels.x_strides))
    table = torch.zeros(levels.total_entries, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiples"):
        quad_kernel.quad_build(table, odd)
    with pytest.raises(ValueError, match="multiples"):
        quad_kernel.quad_fold(torch.zeros_like(table), odd)


def test_train_step_on_cuda_matches_cpu(cuda):
    """The tiny-config training forward + backward (chip_smoke.py's train
    reference: contrast-scaled bf16 parameters, a 30%-fill grid, budget
    below R*S) on the GPU vs the port's CPU path, within its stated bound
    (chip_smoke.TRAIN_REF_TOL)."""
    cfg = flagship_model_config(tiny=True)
    cfg.sampling.global_budget_fraction = 0.5
    params = add_contrast(NeRSembleModel(cfg, "cpu").init_params(
        torch.Generator().manual_seed(0)))
    ref_losses, ref_grads = chip_smoke.tiny_train_grads(cfg, params, "cpu")
    before = (tfm.LAUNCHES, tfm.BWD_LAUNCHES, quad_kernel.LAUNCHES,
              quad_kernel.FOLD_LAUNCHES)
    losses, grads = chip_smoke.tiny_train_grads(cfg, params, cuda)
    torch.cuda.synchronize()
    after = (tfm.LAUNCHES, tfm.BWD_LAUNCHES, quad_kernel.LAUNCHES,
             quad_kernel.FOLD_LAUNCHES)
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert losses.keys() == ref_losses.keys() and len(losses) == 6
    for k in losses:
        assert losses[k] == pytest.approx(ref_losses[k],
                                          rel=chip_smoke.TRAIN_REF_TOL["loss_rtol"], abs=1e-9), k
    for k, ref in ref_grads.items():
        scale = float(ref.abs().max())
        assert scale > 0, k
        atol = (chip_smoke.TRAIN_REF_TOL["table_atol"] if k == "field.table"
                else chip_smoke.TRAIN_REF_TOL["atol"]) * scale
        torch.testing.assert_close(grads[k], ref, rtol=chip_smoke.TRAIN_REF_TOL["rtol"],
                                   atol=atol, msg=k)


def test_render_rays_on_cuda_matches_cpu(cuda):
    """The tiny slice in bf16 through both kernels vs the CPU plain path,
    with contrast added to the random init so that the hash table, the time
    codes and the warp all shape the output. Tolerance 1e-4: the two paths
    share all code but the kernels (B3 bit-exact, B1-fwd summing in another
    order); a quad table with two quarters swapped moves a frame of this
    scene by 2.6e-3 or more."""
    cfg = flagship_model_config(tiny=True)
    cfg.sampling.global_budget_fraction = 0.125
    cpu_model, gpu_model = NeRSembleModel(cfg, "cpu"), NeRSembleModel(cfg, cuda)
    params = add_contrast(cpu_model.init_params(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    occ = torch.from_numpy((rng.uniform(size=16 ** 3) < 0.3).astype(np.float32))
    d = rng.normal(size=(256, 3)) * [0.05, 0.3, 0.3] + [1.0, 0.0, 0.0]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = {"origins": torch.tensor([[-8.0, 0.0, 0.0]]).repeat(256, 1),
            "directions": torch.from_numpy(d.astype(np.float32)),
            "timesteps": torch.from_numpy(rng.integers(0, 8, 256))}
    sched = {"window_deform": 7.0, "window_hash": 8.0}
    ref = cpu_model.render_rays(params, rays, cpu_model.binaries(occ), sched)
    before = (tfm.LAUNCHES, quad_kernel.LAUNCHES)
    out = gpu_model.render_rays(params.to(cuda),
                                {k: v.to(cuda) for k, v in rays.items()},
                                gpu_model.binaries(occ.to(cuda)), sched)
    assert tfm.LAUNCHES > before[0] and quad_kernel.LAUNCHES > before[1]
    assert float(ref["accumulation"].max()) > 0.01
    assert float(ref["deformation"].abs().max()) > 1e-4
    for key in ("rgb", "depth", "accumulation", "deformation"):
        torch.testing.assert_close(out[key].cpu(), ref[key], rtol=0.0,
                                   atol=1e-4)


# -- the measurement path's copy kernels (P1-P4): copies, so bit-exact --------

@pytest.mark.parametrize("entries,width,rows,depth,dtype,idx_dtype", [
    (1000, 128, 4096, 32, torch.bfloat16, torch.int32),   # the probe's rows
    (1000, 128, 4099, 64, torch.bfloat16, torch.int64),   # rows % depth != 0
    (77, 64, 37, 16, torch.float32, torch.int32),         # fewer rows than a group
    (513, 8, 1001, 8, torch.bfloat16, torch.int64),       # 16-byte rows
    (300, 24, 3, 64, torch.float32, torch.int32),         # 96-byte rows, 3 rows
    (3, 128, 0, 32, torch.bfloat16, torch.int32),         # no rows
    (23, 128, 40, 8, torch.bfloat16, torch.int32),        # five whole groups
    (23, 128, 37, 64, torch.bfloat16, torch.int32),       # one partial group
    (23, 24, 50, 16, torch.float32, torch.int64),         # 6 chunks, ragged lanes
    (23, 8, 9, 32, torch.bfloat16, torch.int32),          # 1 chunk per row
])
def test_gather_rows_kernel_is_bit_exact(cuda, entries, width, rows, depth,
                                         dtype, idx_dtype):
    g = torch.Generator(device=cuda).manual_seed(5)
    table = torch.randn(entries, width, generator=g, device=cuda).to(dtype)
    idx = torch.randint(0, entries, (rows,), generator=g, device=cuda,
                        dtype=idx_dtype)
    before = copy_kernels.GATHER_LAUNCHES
    out = copy_kernels.gather_rows_cuda(table, idx, depth)
    torch.cuda.synchronize()
    assert copy_kernels.GATHER_LAUNCHES == before + 1
    assert torch.equal(out, copy_kernels.gather_rows_plain(table, idx))


def test_gather_rows_kernel_reads_past_2_gib(cuda):
    """Rows above byte offset 2^31 of the table (64-bit offsets)."""
    entries = (2 ** 31) // 256 + 4096
    table = torch.zeros(entries, 128, dtype=torch.bfloat16, device=cuda)
    table[-4096:] = torch.randn(4096, 128, device=cuda).to(torch.bfloat16)
    idx = torch.arange(entries - 4096, entries, device=cuda,
                       dtype=torch.int32).flip(0)
    out = copy_kernels.gather_rows_cuda(table, idx, 32)
    torch.cuda.synchronize()
    assert torch.equal(out, table.index_select(0, idx))


@pytest.mark.parametrize("rows,width,block,dtype", [
    (4096, 64, 2048, torch.bfloat16),   # whole blocks
    (5000, 64, 2048, torch.bfloat16),   # a ragged last block
    (1000, 8, 256, torch.bfloat16),     # 16-byte rows
    (777, 12, 100, torch.float32),      # 48-byte rows, ragged
    (3, 64, 2048, torch.bfloat16),      # fewer rows than a block
    (100, 64, 32, torch.bfloat16),      # small blocks, ragged last block
    (77, 12, 10, torch.float32),        # 3 chunks per row, ragged
    (5, 8, 8, torch.bfloat16),          # 1 chunk per row, one block
    (100003, 64, 2048, torch.bfloat16), # 49 blocks, ragged: P2's grid stride
    (70001, 8, 3, torch.bfloat16),      # 23,334 three-row blocks
])
def test_copy_ladder_kernels_are_bit_exact(cuda, rows, width, block, dtype):
    g = torch.Generator(device=cuda).manual_seed(6)
    seven = [torch.randn(rows, width, generator=g, device=cuda).to(dtype)
             for _ in range(7)]
    x = seven[0]
    before = copy_kernels.counts()
    assert torch.equal(copy_kernels.copy_cuda(x, block), copy_kernels.copy_plain(x))
    assert torch.equal(copy_kernels.bcast_quarters_cuda(x, block),
                       copy_kernels.bcast_quarters_plain(x))
    assert torch.equal(copy_kernels.fetch7_cuda(*seven, block=block),
                       copy_kernels.fetch7_plain(*seven))
    torch.cuda.synchronize()
    after = copy_kernels.counts()
    assert [after[k] - before[k] for k in ("copy", "bcast_quarters", "fetch7")] \
        == [1, 1, 1]


def test_copy_kernel_copies_past_2_gib(cuda):
    """A [E, 64] bf16 table over 2^31 bytes with a ragged last block
    (64-bit offsets in the persistent copy's grid stride)."""
    rows = (2 ** 31) // 128 + 2048 + 7
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(rows, 64, generator=g, device=cuda).to(torch.bfloat16)
    before = copy_kernels.COPY_LAUNCHES
    out = copy_kernels.copy_cuda(x)
    torch.cuda.synchronize()
    assert copy_kernels.COPY_LAUNCHES == before + 1
    assert x.numel() * x.element_size() > 2 ** 31
    assert torch.equal(out, x)


def test_bcast_quarters_kernel_writes_past_2_gib(cuda):
    """An [E, 4W] output over 2^31 bytes (64-bit output offsets)."""
    rows = (2 ** 31) // 512 + 2048 + 7  # 512-byte output rows, ragged
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(rows, 64, generator=g, device=cuda).to(torch.bfloat16)
    out = copy_kernels.bcast_quarters_cuda(x)
    torch.cuda.synchronize()
    assert out.numel() * out.element_size() > 2 ** 31
    assert torch.equal(out, copy_kernels.bcast_quarters_plain(x))
    del out
    out = copy_kernels.fetch7_cuda(*[x] * 7)
    torch.cuda.synchronize()
    assert torch.equal(out[-4096:], torch.cat([x[-4096:]] * 4, dim=1))


def test_copy_kernels_reject_bad_inputs(cuda):
    x = torch.randn(64, 64, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError):
        copy_kernels.copy_cuda(x.t())                       # non-contiguous
    with pytest.raises(ValueError):
        copy_kernels.bcast_quarters_cuda(x.half())          # fp16
    with pytest.raises(ValueError):
        copy_kernels.fetch7_cuda(*[x] * 6)                  # six inputs
    with pytest.raises(ValueError):
        copy_kernels.gather_rows_cuda(x, torch.zeros(4, dtype=torch.int32,
                                                     device=cuda), depth=12)
    with pytest.raises(ValueError):
        copy_kernels.gather_rows_cuda(torch.randn(8, 128, device=cuda),  # 512 B rows
                                      torch.zeros(4, dtype=torch.int32, device=cuda))


# the train CLI's tiny flags (tests/test_cli.py's smoke run)
TINY_CLI = ["30", "SYN-1", "--n-train-rays", "64", "--num-levels", "4",
            "--log2-hashmap-size", "9", "--max-res", "32", "--grid-resolution", "16",
            "--n-hash-encodings", "4", "--latent-dim-time", "4",
            "--latent-dim-time-deform", "8", "--mlp-num-layers", "2",
            "--mlp-layer-width", "16", "--max-samples-per-ray", "24",
            "--max-candidates-per-ray", "64", "--window-deform-end", "4",
            "--window-hash-encodings-begin", "4", "--window-hash-encodings-end", "8",
            "--steps-per-eval-image", "0", "--max-num-iterations", "8"]


@pytest.fixture
def capture(tmp_path, monkeypatch):
    """A tiny synthetic capture, and the port's data and model roots in
    ``tmp_path``."""
    from nersemble_tpu_torch import env
    from nersemble_tpu_torch.utils.synthetic_capture import write_capture
    write_capture(tmp_path / "data", 30, "SYN-1", n_timesteps=3, original_size=(64, 88))
    monkeypatch.setattr(env, "NERSEMBLE_DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setattr(env, "NERSEMBLE_MODELS_PATH", str(tmp_path / "models"))
    return tmp_path


def test_train_cli_on_cuda_matches_cpu(cuda, capture):
    """The tiny train CLI run, 8 steps, on the card and on the CPU: the same
    host draws, so the logged losses agree to chip_smoke.TRAIN_REF_TOL's
    loss tolerance; the four train-path kernels launch on the card."""
    from nersemble_tpu_torch.scripts import train_nersemble
    cpu = train_nersemble.main(TINY_CLI + ["--device", "cpu", "--name", "cpu"])
    before = (tfm.LAUNCHES, tfm.BWD_LAUNCHES, quad_kernel.LAUNCHES,
              quad_kernel.FOLD_LAUNCHES)
    gpu = train_nersemble.main(TINY_CLI + ["--name", "gpu"])
    after = (tfm.LAUNCHES, tfm.BWD_LAUNCHES, quad_kernel.LAUNCHES,
             quad_kernel.FOLD_LAUNCHES)
    assert all(a > b for a, b in zip(after, before)), (before, after)
    losses = {}
    for name in ("cpu", "gpu"):
        path = capture / "models" / "nersemble" / f"NERS-00{1 + (name == 'gpu')}-{name}"
        records = [json.loads(line) for line in (path / "metrics.jsonl").read_text().splitlines()]
        losses[name] = {r["step"]: r["train_loss"] for r in records if "train_loss" in r}
    assert set(losses["gpu"]) == set(losses["cpu"]) == {0, 7}
    for step, ref in losses["cpu"].items():
        assert losses["gpu"][step] == pytest.approx(
            ref, rel=chip_smoke.TRAIN_REF_TOL["loss_rtol"]), (step, losses)
    assert gpu["loss"] == pytest.approx(cpu["loss"], rel=chip_smoke.TRAIN_REF_TOL["loss_rtol"])


def test_device_batches_through_pinned_slots(cuda, capture):
    """More steps than the ring has slots: every batch on the card equals
    ``batch_for_step`` after the slots were refilled under it."""
    from nersemble_tpu_torch.config import DataConfig
    from nersemble_tpu_torch.data.dataparser import NeRSembleDataParser
    from nersemble_tpu_torch.data.dataset import NeRSembleDataset
    from nersemble_tpu_torch.data.ray_batcher import DeviceBatches, RayBatcher
    config = DataConfig(participant_id=30, sequence_name="SYN-1", n_timesteps=3,
                        scale_factor=9.0, use_depth_maps=True,
                        train_num_rays_per_batch=4096,
                        train_num_times_to_repeat_images=3)
    outputs = NeRSembleDataParser(config).generate_outputs("train")
    batcher = RayBatcher(NeRSembleDataset(outputs, config), config, seed=5)
    batches = DeviceBatches(batcher, 2, cuda)
    try:
        got = [next(batches) for _ in range(12)]
    finally:
        batches.close()
    assert len(batches._slots) == 4
    torch.cuda.synchronize()
    for i, batch in enumerate(got):
        want = batcher.batch_for_step(2 + i)
        assert set(batch) == {"origins", "directions", "rgb", "timesteps",
                              "camera_indices", "alpha", "depth"}
        for key, value in batch.items():
            assert value.device.type == "cuda"
            assert np.array_equal(value.cpu().numpy(), want[key]), (i, key)


def _adam_tree(device, shapes, offset=0):
    """A ParamTree of f32 leaves {name: shape} under three groups' top-level
    keys, each leaf a view ``offset`` elements into its own buffer, and a
    zero Adam state of views at the same offset."""
    from nersemble_tpu_torch.engine.optimizers import AdamState

    gen = torch.Generator(device=device).manual_seed(7)

    def tree(fill):
        out = {}
        for name, shape in shapes.items():
            n = int(np.prod(shape))
            buf = fill(n + offset)
            node = out
            *path, leaf = name.split(".")
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = buf[offset:].view(shape)
        return ParamTree(out)

    params = tree(lambda n: torch.randn(n, generator=gen, device=device))
    state = AdamState(torch.zeros((), dtype=torch.int32, device=device),
                      tree(lambda n: torch.zeros(n, device=device)),
                      tree(lambda n: torch.zeros(n, device=device)))
    return params, state


_ADAM_GROUPS = {"field": "fields", "deformation": "deformation_field",
                "time_embedding": "embeddings", "time_embedding_deformation": "embeddings"}


def _adam_case(case, device):
    """(params, state, key_to_group, steps' keywords, launches a step)."""
    from nersemble_tpu_torch.engine.optimizers import AdamState

    if case == "flagship":
        params, state, key_to_group = chip_smoke.adam_flagship(device)
        return params, state, key_to_group, {}, 1
    if case == "odd counts, a leaf without a gradient":
        params, state = _adam_tree(device, {
            "field.table": (4099,), "field.mlp_base.w": (7, 3),
            "deformation.b": (3,), "time_embedding": (1,),
            "time_embedding_deformation": (8, 4)})
        return params, state, _ADAM_GROUPS, {"skip": ("time_embedding_deformation",)}, 1
    if case == "leaves 4 bytes into their buffers":  # heads, bodies, tails
        params, state = _adam_tree(device, {"field.table": (1001, 2),
                                            "deformation.w": (64, 3),
                                            "time_embedding": (2,)}, offset=1)
        return params, state, _ADAM_GROUPS, {}, 1
    if case.startswith("row shard"):
        # the moments-only layout: the table's rows from an odd row on, its
        # moments those rows alone
        width = 2 if "2-wide" in case else 64
        params, state = _adam_tree(device, {"field.table": (1001, width),
                                            "time_embedding": (16, 4)})
        rows = slice(501, 1001)
        for moments in (state.mu, state.nu):
            moments.field.table = torch.nn.Parameter(
                moments.field.table[rows].contiguous(), requires_grad=False)
        return params, state, _ADAM_GROUPS, {"shards": {"field.table": rows}}, 1
    if case == "bf16 gradient":
        params, state = _adam_tree(device, {"field.table": (4097, 3),
                                            "deformation.w": (5,)})
        return (params, state, _ADAM_GROUPS,
                {"shards": {"field.table": slice(None), "deformation.w": slice(None)},
                 "g_dtypes": {"field.table": torch.bfloat16,
                              "deformation.w": torch.bfloat16}}, 1)
    assert case == "more segments than one launch takes"
    # 70 leaves of 5 elements: a body and a tail each, 140 segments
    params, state = _adam_tree(device, {f"deformation.w{i}": (5,) for i in range(70)})
    return params, state, _ADAM_GROUPS, {}, 3


ADAM_CASES = ["flagship", "odd counts, a leaf without a gradient",
              "leaves 4 bytes into their buffers", "row shard at an odd row",
              "row shard of 2-wide rows at an odd row", "bf16 gradient",
              "more segments than one launch takes"]


@pytest.mark.parametrize("case", ADAM_CASES)
def test_fused_adam_kernel_matches_plain_over_three_steps(cuda, case):
    """Three Adam steps through ``fused_adam_update`` (the step count on
    the card) by the kernel and by the plain update from the same start:
    parameters and both moments bit for bit, no synchronising call, the
    expected launches."""
    from nersemble_tpu_torch.ops import fused_adam

    params, state, key_to_group, kw, per_step = _adam_case(case, cuda)
    state = chip_smoke.adam_steps(params, state, key_to_group, plain=True, **kw)
    want = [t.clone() for tree in (params, state.mu, state.nu) for t in tree.parameters()]
    del params, state
    params, state, key_to_group, kw, per_step = _adam_case(case, cuda)
    trees = (params, state.mu, state.nu)
    versions = [t._version for tree in trees for t in tree.parameters()]
    before = fused_adam.LAUNCHES
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = chip_smoke.adam_steps(params, state, key_to_group, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert fused_adam.LAUNCHES == before + chip_smoke.ADAM_STEPS * per_step
    assert int(state.count) == chip_smoke.ADAM_STEPS
    got = [t for tree in (params, state.mu, state.nu) for t in tree.parameters()]
    assert len(got) == len(want)
    for i, (mine, theirs) in enumerate(zip(got, want)):
        assert torch.equal(mine, theirs), (case, i)
    # the leaf without a gradient keeps its zero moments; every other moves,
    # and its version counter with it (caches keyed by it, such as the fused
    # MLPs' packed weights, must see the update)
    for name, mu in state.mu.named_parameters():
        assert bool(mu.any()) == (name not in kw.get("skip", ())), name
    stepped = [name not in kw.get("skip", ()) for tree in trees
               for name, _ in tree.named_parameters()]
    for was, t, moved in zip(versions, (t for tree in trees for t in tree.parameters()),
                             stepped):
        assert (t._version > was) == moved


def test_fused_adam_kernel_refuses_what_it_cannot_take(cuda):
    from nersemble_tpu_torch.ops import fused_adam

    c = torch.ones((), device=cuda)
    p, mu, nu = (torch.zeros(8, 4, device=cuda) for _ in range(3))
    for g, match in ((torch.zeros(4, 8, device=cuda).t(), "contiguous"),
                     (torch.zeros(8, 4, dtype=torch.float16, device=cuda), "bf16"),
                     (torch.zeros(8, 4), "is on cpu")):
        with pytest.raises(ValueError, match=match):
            fused_adam.adam_update([(p, g, mu, nu, 1e-3)], c, c, 0.9, 0.999, 1e-15)
    with pytest.raises(ValueError, match="f32"):
        fused_adam.adam_update([(p.double(), p, mu, nu, 1e-3)], c, c, 0.9, 0.999, 1e-15)


# the time codes' backward (csrc/time_code_bwd.cu): the cells' two code widths;
# 1 and 16 timesteps in one row tile, 476 (a long sequence) and 2000 in many
TC_WIDTHS = [32, 128]
TC_ROWS = [1, 16, 476, 2000]
TC_SAMPLES = [0, 1, 255, 131072, 372000]
# the gradient as it arrives: whole rows, a column slice of a wider
# gradient (16-byte aligned: float4 loads), one that is not (scalar loads)
TC_LAYOUTS = {"contiguous": 0, "column slice": 16, "unaligned column slice": 1}


def _tc_grad(g, layout):
    offset = TC_LAYOUTS[layout]
    if not offset:
        return g
    wide = torch.zeros(g.shape[0], g.shape[1] + 2 * offset, device=g.device)
    wide[:, offset:offset + g.shape[1]] = g
    return wide[:, offset:offset + g.shape[1]]


@pytest.mark.parametrize("layout", list(TC_LAYOUTS))
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", TC_SAMPLES)
@pytest.mark.parametrize("t_rows", TC_ROWS)
@pytest.mark.parametrize("d", TC_WIDTHS)
def test_time_code_kernel_matches_float64_sums(cuda, d, t_rows, n, index_dtype, layout):
    """Each row of the gradient within gamma_k (the kernel's longest chain
    of f32 additions, chip_smoke.time_code_gamma) of the sum of its terms'
    magnitudes from the float64 sum: the bound on any order of f32 sums."""
    from nersemble_tpu_torch.ops import time_code

    g, idx = chip_smoke.time_code_inputs(n, t_rows, d, 32, cuda, seed=n + d)
    grad = _tc_grad(g, layout)
    before = time_code.LAUNCHES
    out = time_code.time_code_bwd_cuda(grad, idx.to(index_dtype), t_rows)
    torch.cuda.synchronize()
    assert time_code.LAUNCHES == before + 1
    assert out.shape == (t_rows, d) and out.dtype == torch.float32
    chip_smoke.time_code_check(out, g, idx, t_rows, chip_smoke.time_code_gamma(n, t_rows, d))
    if n == 0:
        assert not out.any()


# (D, T, N): rows of four columns and of fewer (6, 1: scalar loads, idle
# lanes), one and several row tiles, one block and several
TC_PLAIN_CASES = [(32, 16, 255), (128, 16, 4097), (6, 16, 1000), (128, 476, 3000),
                  (32, 17, 5000), (1, 3, 700), (128, 2000, 600)]


@pytest.mark.parametrize("d,t_rows,n", TC_PLAIN_CASES)
def test_time_code_kernel_gives_the_plain_versions_bits(cuda, d, t_rows, n):
    """The kernel against ``time_code_bwd_plain``, which walks the same plan
    in the same order in numpy, bit for bit; runs of 1 to 40 samples, and
    indices outside [0, T) that add nowhere."""
    from nersemble_tpu_torch.ops import time_code

    gen = torch.Generator(device=cuda).manual_seed(d * t_rows + n)
    g = torch.randn(n, d, generator=gen, device=cuda)
    runs = torch.randint(1, 41, (n,), generator=gen, device=cuda)
    rows = torch.randint(-1, t_rows + 1, (n,), generator=gen, device=cuda)
    idx = rows.repeat_interleave(runs)[:n]
    out = time_code.time_code_bwd_cuda(g, idx, t_rows)
    assert torch.equal(out.cpu(), time_code.time_code_bwd_plain(g, idx, t_rows))


@pytest.mark.parametrize("d", TC_WIDTHS)
@pytest.mark.parametrize("t_rows", [16, 476])
def test_time_code_kernel_repeats_bit_for_bit(cuda, d, t_rows):
    from nersemble_tpu_torch.ops import time_code

    g, idx = chip_smoke.time_code_inputs(372000, t_rows, d, 91, cuda)
    first = time_code.time_code_bwd_cuda(g, idx, t_rows)
    assert torch.equal(first, time_code.time_code_bwd_cuda(g, idx, t_rows))


@pytest.mark.parametrize("d", TC_WIDTHS)
@pytest.mark.parametrize("n", [255, 131072, 372000])
def test_time_code_kernel_against_the_indexing_backward(cuda, d, n):
    """Against the card's own backward of ``weight[index]``: each of the two
    lies within gamma_k of its terms' magnitudes of the exact sum, k the
    longest chain of additions (the kernel's plan; PyTorch's walk sums a
    row's samples in one chain, so at most n), so they lie within the sum
    of the two gammas of each other."""
    from nersemble_tpu_torch.ops import time_code

    g, idx = chip_smoke.time_code_inputs(n, 16, d, 32, cuda)
    weight = torch.zeros(16, d, device=cuda, requires_grad=True)
    (theirs,) = torch.autograd.grad(weight[idx], weight, g)
    mine = time_code.time_code_bwd_cuda(g, idx, 16)
    mag = torch.zeros(16, d, dtype=torch.float64, device=cuda).index_add_(
        0, idx, g.double().abs())
    gamma = chip_smoke.time_code_gamma(n, 16, d) + chip_smoke.sum_gamma(n)
    assert bool(((mine.double() - theirs.double()).abs() <= gamma * mag).all())


def test_time_code_gather_on_the_card(cuda):
    """The model's gather of a CUDA weight: ``weight[index]``'s bits
    forward, the kernel's gradient backward (one launch, no synchronising
    call), for both index types and a 2-D index."""
    from nersemble_tpu_torch.models import nersemble
    from nersemble_tpu_torch.ops import time_code

    gen = torch.Generator(device=cuda).manual_seed(5)
    weight = torch.randn(16, 128, generator=gen, device=cuda, requires_grad=True)
    for idx in (torch.randint(0, 16, (4096,), generator=gen, device=cuda),
                torch.randint(0, 16, (64, 32), generator=gen, device=cuda).int()):
        g = torch.randn(*idx.shape, 128, generator=gen, device=cuda)
        before = time_code.LAUNCHES
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rows = nersemble._gather_rows(weight, idx)
            (grad,) = torch.autograd.grad(rows, weight, g)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert time_code.LAUNCHES == before + 1
        assert torch.equal(rows, weight[idx])
        assert torch.equal(grad, time_code.time_code_bwd_cuda(g, idx, 16))


def test_time_code_kernel_refuses_what_it_cannot_take(cuda):
    from nersemble_tpu_torch.ops import time_code

    idx = torch.zeros(8, dtype=torch.int64, device=cuda)
    g = torch.zeros(8, 32, device=cuda)
    for args, match in (((g.bfloat16(), idx), "f32 gradient"),
                        ((g, idx.float()), "int32 or int64"),
                        ((g, idx.cpu()), "one card"),
                        ((g[:4], idx), "8 indices for 4"),
                        ((torch.zeros(8, 1025, device=cuda), idx), "rows of 1 to 1024")):
        with pytest.raises(ValueError, match=match):
            time_code.time_code_bwd_cuda(*args, 16)
