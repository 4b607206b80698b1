"""The SE(3) warp's elementwise chain (``ops/se3_warp.py``): on the CPU,
the plain chain that the card's kernels are held to; then, marked ``cuda``,
the kernels themselves on the card against that chain.

CPU: ``warp_input`` is ``windowed_posenc`` and the concatenation bit for bit,
and hands the code its columns of the gradient (what the kernel's backward
does); ``se3_offsets`` is the guarded chain at screw scales on both sides of
the Taylor branch's |r|^2 = 1e-8, with the JAX guard's values and no gradient
on the rows it replaces, and zero gradient past the head's 6 columns; the CPU
path launches no kernel.

Card (``python -m pytest --noconftest -m cuda tests/test_torch_se3_warp.py``;
the kernels have no CPU mode and skip without a GPU): the three kernels
against the chain (the encoding and concatenation; ``se3_offsets_plain`` and
its autograd backward) at a field chunk of each cell (65,536 and 93,184
rows), with rows on both sides of the threshold, one launch a call, positions
that require a gradient refused, no host synchronisation in a forward and
backward of ``deformation_offsets``, and the NaN guard's cases of
tests/test_torch_nan_guards.py on the card against the CPU.
"""

import pytest
import torch

from nersemble_tpu_torch.config import SE3DeformationFieldConfig
from nersemble_tpu_torch.models.deformation import (
    deformation_offsets,
    init_deformation_field,
)
from nersemble_tpu_torch.ops import launch_counts
from nersemble_tpu_torch.ops import se3_warp as sw
from nersemble_tpu_torch.ops.posenc import windowed_posenc
from nersemble_tpu_torch.utils.params import ParamTree

SCALES = [0.0, 1e-6, 1e-4, 1e-2, 1.0, 3.0]  # |r| per row: t2 = 0 to ~27
WINDOWS = [None, 0.0, 2.5, 3.37, 7.0]  # deformation window: off, closed, partial, open
# rows the guard replaces: NaN in v, NaN in r, |r|^2 overflowing f32
BAD_ROWS = {5: (0, float("nan")), 9: (4, float("nan")), 17: (slice(3, 6), 1e25)}
# rows whose |r|^2 lies just below and just above the Taylor branch's 1e-8
THRESHOLD_ROWS = {row: 0.99e-8 if row % 2 else 1.01e-8 for row in range(32, 64)}
WARP_KERNELS = ("warp_input", "se3_warp_fwd", "se3_warp_bwd")


def _at_threshold(h: torch.Tensor, rows) -> torch.Tensor:
    """``h`` with the r of each of ``rows`` (row: |r|^2) rescaled to that
    squared norm, its direction kept (the x axis where r is 0)."""
    h = h.clone()
    for row, t2 in rows.items():
        r = h[row, 3:6]
        norm = r.norm()
        direction = r / norm if norm > 0 else torch.tensor([1.0, 0.0, 0.0])
        h[row, 3:6] = direction * t2 ** 0.5
    return h


def _screws(n: int, scale: float, seed: int = 0, width: int = sw.SCREW,
            bad: bool = True) -> torch.Tensor:
    """[n, width] f32 head rows: v ~ N(0, 1), r ~ N(0, scale^2), the
    guarded rows of BAD_ROWS."""
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(n, width, generator=gen)
    h[:, 3:6] *= scale
    if bad:
        for row, (cols, value) in BAD_ROWS.items():
            h[row, cols] = value
    return h


def _positions(n: int, seed: int = 1) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(n, 3, generator=gen) * 1.2 - 0.1  # a tenth outside the box


def _autograd(screw: torch.Tensor, pos: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    s = screw.detach().clone().requires_grad_(True)
    sw.se3_offsets_plain(s, pos.to(s.dtype)).backward(g.to(s.dtype))
    return s.grad


def _good_rows(n: int) -> torch.Tensor:
    good = torch.ones(n, dtype=torch.bool)
    good[list(BAD_ROWS)] = False
    return good


def _fwd_tolerance(screw, pos, ref32):
    """Per element: 4 ulps of the row's |p|_1 + |v|_1 + 1 (the terms' scale),
    plus twice the float32 chain's largest error against float64 in the
    element's row (none on the guarded rows): at |r| ~1e-4-1e-2 the chain's
    (1 - cos t) / t^2 and (t - sin t) / t^3 cancel in f32, in the kernel
    and the chain alike, by as much as the row's r and v make them matter."""
    truth = sw.se3_offsets_plain(screw.double().cpu(), pos.double().cpu())
    err = (ref32.double().cpu() - truth).abs().amax(dim=1, keepdim=True)
    err = torch.where(_good_rows(screw.shape[0])[:, None], err, torch.zeros_like(err))
    scale = torch.nan_to_num(1 + pos.abs().sum(-1, keepdim=True)
                             + screw[:, :3].abs().sum(-1, keepdim=True))
    return 4 * torch.finfo(torch.float32).eps * scale + 2 * err.to(ref32.device, torch.float32)


def _bwd_tolerance(screw, pos, g, ref32):
    """Per element: 1e-5 (1 + |ref|), plus a quarter of the float32 chain's
    largest error against float64 in the element's column (over the good
    rows: in float64 no |r|^2 overflows)."""
    truth = _autograd(screw.double().cpu(), pos.double().cpu(), g.double().cpu())
    err = (ref32.double().cpu() - truth)[_good_rows(screw.shape[0])].abs().amax(dim=0)
    return 1e-5 * (1 + ref32.abs()) + 0.25 * err.to(ref32.device, torch.float32)


def _stem_input(pos, code, n_freq, window):
    """The chain the warp-input kernel replaces: the encoding, then the code."""
    enc = windowed_posenc(pos, n_freq, min_freq_exp=0.0, max_freq_exp=n_freq - 1,
                          include_input=True, window_param=window)
    return torch.cat([enc, code], dim=-1)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("n_freq,d", [(7, 128), (4, 8)])
def test_warp_input_on_the_cpu_is_windowed_posenc_and_cat(window, n_freq, d):
    """The CPU path's values bit for bit, and its backward: the code gets
    columns 6F + 3: of the gradient (as the kernel's backward hands it), the
    positions keep theirs."""
    pos = _positions(2051).requires_grad_(True)
    code = torch.randn(2051, d, generator=torch.Generator().manual_seed(2),
                       requires_grad=True)
    out = sw.warp_input(pos, code, n_freq, window)
    assert out.shape == (2051, 6 * n_freq + 3 + d)
    assert torch.equal(out, _stem_input(pos.detach(), code.detach(), n_freq, window))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    out.backward(g)
    assert torch.equal(code.grad, g[:, 6 * n_freq + 3:])
    assert pos.grad is not None and torch.isfinite(pos.grad).all()


@pytest.mark.parametrize("scale", SCALES + [0.99e-8, 1.01e-8])
def test_se3_offsets_on_the_cpu_is_the_guarded_chain(scale):
    """``se3_offsets`` on a [N, 128] head: the guarded chain's offsets, the
    JAX guard's values on the rows it replaces (the position in the NaN
    coordinates: offset 0) with no gradient there, and a finite gradient
    that is zero past the head's 6 columns. ``scale`` below 1e-7 is |r|^2
    of the rows THRESHOLD_ROWS names, just below or above 1e-8."""
    n, threshold = 4099, 0 < scale < 1e-7
    head = _screws(n, 1.0 if threshold else scale, width=128)
    if threshold:
        head = _at_threshold(head, dict.fromkeys(THRESHOLD_ROWS, scale))
        t2 = (head[list(THRESHOLD_ROWS), 3:6] ** 2).sum(-1)
        assert (t2 < 1e-8).all() if scale < 1e-8 else not (t2 < 1e-8).any()
    pos = _positions(n)
    leaf = head.clone().requires_grad_(True)
    off = sw.se3_offsets(leaf, pos)
    assert torch.equal(off, sw.se3_offsets_plain(head[:, :sw.SCREW], pos))
    assert torch.isfinite(off).all()
    for row in BAD_ROWS:  # every coordinate of these rows' warps is NaN
        assert (off[row] == 0).all()
    g = torch.randn(n, 3, generator=torch.Generator().manual_seed(3))
    off.backward(g)
    assert torch.isfinite(leaf.grad).all() and (leaf.grad[:, sw.SCREW:] == 0).all()
    assert (leaf.grad[list(BAD_ROWS)] == 0).all()
    assert torch.equal(leaf.grad[:, :sw.SCREW], _autograd(head[:, :sw.SCREW], pos, g))


def test_the_cpu_path_launches_nothing():
    """On CPU tensors ``deformation_offsets`` runs the plain chain, forward
    and backward, and counts no launch of the warp kernels."""
    cfg = SE3DeformationFieldConfig(mlp_num_layers=2, mlp_layer_width=16,
                                    warp_code_dim=8, skip_connections=())
    params = _deformation(cfg, "cpu")
    code = torch.randn(300, 8, requires_grad=True)
    before = launch_counts.read(WARP_KERNELS)
    off = deformation_offsets(params, _positions(300), code, cfg, window_param=2.5,
                              compute_dtype=torch.float32)
    off.sum().backward()
    assert launch_counts.read(WARP_KERNELS) == before
    assert torch.isfinite(code.grad).all()


# ---- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CHUNKS = [65536, 93184]  # a field chunk of nersemble.train and of nersemble_seq97.train


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 3.37])
@pytest.mark.parametrize("n", CHUNKS)
def test_warp_input_kernel_is_the_plain_version(cuda, n, window):
    pos = _positions(n).to(cuda)
    code = torch.randn(n, 128, generator=torch.Generator().manual_seed(5)).to(cuda)
    before = launch_counts.read()["warp_input"]
    out = sw.warp_input_cuda(pos, code, 7, window)
    assert launch_counts.read()["warp_input"] == before + 1
    ref = _stem_input(pos, code, 7, window)
    # equal bit for bit as the stem reads it (bf16), the code copied exactly
    assert torch.equal(out.to(torch.bfloat16), ref.to(torch.bfloat16))
    assert torch.equal(out[:, 45:], code)
    # a code with a row stride (the time code shared with the field's)
    wide = torch.randn(n, 160, generator=torch.Generator().manual_seed(6)).to(cuda)
    assert torch.equal(sw.warp_input_cuda(pos, wide[:, 32:], 7, window)[:, 45:], wide[:, 32:])


@pytest.mark.cuda
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("n", CHUNKS)
def test_se3_warp_kernels_are_the_plain_versions(cuda, n, scale):
    """The kernels against the guarded chain on the card and autograd's
    backward of it, with rows on both sides of the Taylor threshold."""
    head = _at_threshold(_screws(n, scale, width=128), THRESHOLD_ROWS).to(cuda)
    pos = _positions(n).to(cuda)
    g = torch.randn(n, 3, generator=torch.Generator().manual_seed(7)).to(cuda)
    before = launch_counts.read()
    off, screw = sw.se3_warp_fwd_cuda(head, pos)
    dhead = sw.se3_warp_bwd_cuda(g, screw, pos, 128)
    after = launch_counts.read()
    assert after["se3_warp_fwd"] == before["se3_warp_fwd"] + 1
    assert after["se3_warp_bwd"] == before["se3_warp_bwd"] + 1
    torch.testing.assert_close(screw, head[:, :6], rtol=0, atol=0, equal_nan=True)
    ref = sw.se3_offsets_plain(head[:, :6], pos)
    for row in BAD_ROWS:
        assert torch.equal(off[row], ref[row])
    gap = (off - ref).abs()
    tol = _fwd_tolerance(head[:, :6], pos, ref)
    assert (gap <= tol).all(), (gap / tol).max()
    ref_g = _autograd(head[:, :6], pos, g)
    assert (dhead[:, 6:] == 0).all() and (dhead[list(BAD_ROWS)] == 0).all()
    gap = (dhead[:, :6] - ref_g).abs()
    tol = _bwd_tolerance(head[:, :6], pos, g, ref_g)
    assert (gap <= tol).all(), (gap / tol).max()
    # a head narrower than a whole float4: a view of the kernel's wider rows
    assert torch.equal(sw.se3_warp_bwd_cuda(g, screw, pos, 6), dhead[:, :6])


@pytest.mark.cuda
def test_positions_that_require_a_gradient_are_refused_on_the_card(cuda):
    """The kernels give the positions no gradient: on the card a warp whose
    positions require one raises, and under no_grad it runs the kernels."""
    pos = _positions(256).to(cuda).requires_grad_(True)
    code = torch.randn(256, 8, device=cuda)
    head = _screws(256, 1.0, width=128).to(cuda)
    with pytest.raises(ValueError, match="no gradient"):
        sw.warp_input(pos, code, 4)
    with pytest.raises(ValueError, match="no gradient"):
        sw.se3_offsets(head, pos)
    before = launch_counts.read(WARP_KERNELS)
    with torch.no_grad():
        sw.warp_input(pos, code, 4)
        sw.se3_offsets(head, pos)
    after = launch_counts.read(WARP_KERNELS)
    assert {k: after[k] - before[k] for k in WARP_KERNELS} == {
        "warp_input": 1, "se3_warp_fwd": 1, "se3_warp_bwd": 0}


def _deformation(cfg, device):
    """The field's seeded parameters on ``device``, the head scaled by 1e3
    (a visible warp), every leaf requiring a gradient."""
    tree = init_deformation_field(torch.Generator().manual_seed(0), cfg)
    tree["head_rv"]["w"] = tree["head_rv"]["w"] * 1e3
    params = ParamTree(tree).to(device)
    for p in params.parameters():
        p.requires_grad_(True)
    return params


@pytest.mark.cuda
def test_a_warp_issues_no_host_sync_and_one_launch_each(cuda):
    """``deformation_offsets`` forward and backward at a flagship field chunk
    on the card under ``set_sync_debug_mode("error")``: one launch of each
    warp kernel, no synchronizing call."""
    cfg = SE3DeformationFieldConfig()
    params = _deformation(cfg, cuda)
    n = CHUNKS[0]
    pos = _positions(n).to(cuda)
    code = torch.randn(n, cfg.warp_code_dim, device=cuda, requires_grad=True)
    g = torch.randn(n, 3, device=cuda)
    torch.autograd.backward(deformation_offsets(params, pos, code, cfg, window_param=3.37), g)
    torch.cuda.synchronize()  # the fused MLP's weights packed, the kernels built
    before = launch_counts.read(WARP_KERNELS)
    torch.cuda.set_sync_debug_mode("error")
    try:
        off = deformation_offsets(params, pos, code, cfg, window_param=3.37)
        torch.autograd.backward(off, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = launch_counts.read(WARP_KERNELS)
    assert {k: after[k] - before[k] for k in WARP_KERNELS} == dict.fromkeys(WARP_KERNELS, 1)
    assert torch.isfinite(code.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bad_rows", [(1, 4), ()], ids=["nan_rows", "finite"])
def test_the_nan_guard_on_the_card_is_the_cpu_one(cuda, bad_rows):
    """tests/test_torch_nan_guards.py's warp: rows whose warp code is 1e25
    drive the screw's squared norm past f32; the card's kernels against the
    CPU's plain chain (which that file holds to JAX), f32 throughout, at
    its tolerance."""
    cfg = SE3DeformationFieldConfig(mlp_num_layers=2, mlp_layer_width=16,
                                    warp_code_dim=8, skip_connections=())
    gen = torch.Generator().manual_seed(3)
    pos = torch.rand(7, 3, generator=gen) * 0.6 + 0.2
    code = torch.randn(7, 8, generator=gen)
    code[list(bad_rows)] *= 1e25
    cot = torch.randn(7, 3, generator=gen)
    runs = {}
    for device in ("cpu", cuda):
        params = _deformation(cfg, device)
        c = code.to(device, copy=True).requires_grad_(True)
        off = deformation_offsets(params, pos.to(device), c, cfg, window_param=None,
                                  compute_dtype=torch.float32, use_fused_mlp=False)
        torch.sum(off * cot.to(device)).backward()
        runs[str(device)] = [off, c.grad] + [p.grad for p in params.parameters()]
    for ours, ref in zip(runs[str(cuda)], runs["cpu"]):
        assert torch.isfinite(ours).all()
        torch.testing.assert_close(ours.cpu(), ref, rtol=1e-5, atol=1e-6)
    assert (runs[str(cuda)][0][list(bad_rows)] == 0).all()
