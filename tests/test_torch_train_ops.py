"""PyTorch port vs the JAX package: the training slice's leaf ops.

trunc_exp, the losses, the distortion loss, psnr, the learning-rate
schedule, quantized_budget, the jittered march, the fused-MLP backward
(plain version vs the Pallas kernel in interpret mode), the quad fold, Adam
and the occupancy EMA update. Inputs come from numpy seeds and cross as
numpy. Tolerances: float32 paths differ only in summation order and libm
ulps (rtol 1e-5 unless stated); copies and integer math are compared
exactly.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import n, t

import __graft_entry__
from nersemble_tpu.config import OptimizerConfig as JaxOptimizerConfig
from nersemble_tpu.engine.optimizers import fused_adam_update as j_adam
from nersemble_tpu.engine.trainer import NeRSembleTrainer as JaxTrainer
from nersemble_tpu.models.field import build_levels as jax_build_levels
from nersemble_tpu.ops import distortion as jdist
from nersemble_tpu.ops import fused_mlp as jfm
from nersemble_tpu.ops import hash_encoding as jhe
from nersemble_tpu.ops import losses as jL
from nersemble_tpu.ops import occupancy as jocc
from nersemble_tpu.ops import sampling as jsamp
from nersemble_tpu.ops.trunc_exp import trunc_exp as j_trunc_exp
from nersemble_tpu.utils import metrics as jM
from nersemble_tpu_torch.config import default_optimizers
from nersemble_tpu_torch.engine.optimizers import (
    fused_adam_update,
    group_of_param,
    init_adam,
)
from nersemble_tpu_torch.engine.checkpoints import params_from_numpy
from nersemble_tpu_torch.ops import distortion as tdist
from nersemble_tpu_torch.ops import fused_mlp as tfm
from nersemble_tpu_torch.ops import losses as tL
from nersemble_tpu_torch.ops import occupancy as tocc
from nersemble_tpu_torch.ops import quad_kernel
from nersemble_tpu_torch.ops import sampling as tsamp
from nersemble_tpu_torch.ops.hash_encoding import HashGridLevels
from nersemble_tpu_torch.ops.mlp import init_mlp
from nersemble_tpu_torch.ops.trunc_exp import trunc_exp
from nersemble_tpu_torch.utils.metrics import psnr
from nersemble_tpu_torch.utils.params import ParamTree, to_tree
from nersemble_tpu_torch.utils.windows import lr_values

F32 = dict(rtol=1e-5, atol=1e-6)


def _grad(fn, *args):
    """(value, grad wrt the first arg) of a torch scalar function."""
    x = args[0].clone().requires_grad_(True)
    out = fn(x, *args[1:])
    out.backward()
    return out.detach(), x.grad


# -- leaf ops ------------------------------------------------------------------

def test_trunc_exp_forward_and_clamped_backward():
    x = np.random.default_rng(0).normal(size=(301,)).astype(np.float32) * 12
    assert (np.abs(x) > 15).any()
    g = np.random.default_rng(1).normal(size=(301,)).astype(np.float32)
    out, vjp = jax.vjp(j_trunc_exp, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    ours = trunc_exp(xt)
    ours.backward(t(g))
    np.testing.assert_allclose(n(ours), n(out), **F32)
    np.testing.assert_allclose(n(xt.grad), n(vjp(jnp.asarray(g))[0]), **F32)


def _ray_batch(seed, R=37, S=24):
    rng = np.random.default_rng(seed)
    t0 = np.sort(rng.uniform(7.0, 9.5, (R, S)), axis=1).astype(np.float32)
    return {
        "weights": rng.uniform(0, 0.2, (R, S)).astype(np.float32),
        "t_starts": t0, "t_ends": (t0 + 0.011).astype(np.float32),
        "mask": rng.uniform(size=(R, S)) > 0.25,
        "depth": np.where(rng.uniform(size=R) < 0.2, 0.0,
                          rng.uniform(7.5, 9.5, R)).astype(np.float32),
        "rgb": rng.uniform(size=(R, 3)).astype(np.float32),
        "rgb_gt": rng.uniform(size=(R, 3)).astype(np.float32),
        "alpha": np.where(rng.uniform(size=R) < 0.3, 1.0,
                          rng.uniform(size=R)).astype(np.float32),
        "acc": rng.uniform(size=(R, 1)).astype(np.float32),
    }


LOSSES = {
    # name: (port fn, jax fn, differentiated input key, other input keys)
    "rgb_masked": (lambda a, b, c: tL.masked_rgb_loss(a, b, c, True, 0.0),
                   lambda a, b, c: jL.masked_rgb_loss(a, b, c, True, 0.0),
                   "rgb", ("rgb_gt", "alpha")),
    "rgb_unmasked": (lambda a, b, c: tL.masked_rgb_loss(a, b, c, False, 0.5),
                     lambda a, b, c: jL.masked_rgb_loss(a, b, c, False, 0.5),
                     "rgb", ("rgb_gt", "alpha")),
    "alpha": (tL.alpha_loss, jL.alpha_loss, "acc", ("alpha",)),
    "empty": (lambda w, a, b, m, d: tL.empty_loss(w, a, b, m, d, 0.05),
              lambda w, a, b, m, d: jL.empty_loss(w, a, b, m, d, 0.05),
              "weights", ("t_starts", "t_ends", "mask", "depth")),
    "near": (lambda w, a, b, m, d: tL.near_loss(w, a, b, m, d, 0.5),
             lambda w, a, b, m, d: jL.near_loss(w, a, b, m, d, 0.5),
             "weights", ("t_starts", "t_ends", "mask", "depth")),
    "near_narrow": (lambda w, a, b, m, d: tL.near_loss(w, a, b, m, d, 0.01),
                    lambda w, a, b, m, d: jL.near_loss(w, a, b, m, d, 0.01),
                    "weights", ("t_starts", "t_ends", "mask", "depth")),
    "depth": (tL.depth_loss, jL.depth_loss, "acc", ("depth",)),
    "distortion": (tdist.distortion_loss, jdist.distortion_loss, "weights",
                   ("t_starts", "t_ends", "mask")),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_gradient_match_jax(name):
    ours_fn, theirs_fn, diff_key, keys = LOSSES[name]
    b = _ray_batch(2)
    value, grad = _grad(ours_fn, t(b[diff_key]), *(t(b[k]) for k in keys))
    j_value, j_grad = jax.value_and_grad(theirs_fn)(
        jnp.asarray(b[diff_key]), *(jnp.asarray(b[k]) for k in keys))
    assert float(value) != 0.0
    np.testing.assert_allclose(float(value), float(j_value), rtol=1e-5)
    np.testing.assert_allclose(n(grad), n(j_grad), rtol=1e-5, atol=1e-7)


def test_distortion_loss_matches_quadratic_reference():
    b = _ray_batch(3, R=5, S=32)
    w, t0, t1, m = (t(b[k]) for k in ("weights", "t_starts", "t_ends", "mask"))
    ray_mask = torch.tensor([True, False, True, True, False])
    per_ray = [float(tdist.distortion_loss_reference(
        w[r] * m[r], (t0[r] + t1[r]) * 0.5, (t1[r] - t0[r]) * m[r]))
        for r in range(5)]
    assert float(tdist.distortion_loss(w, t0, t1, m)) == \
        pytest.approx(np.mean(per_ray), rel=1e-5)
    assert float(tdist.distortion_loss(w, t0, t1, m, ray_mask)) == \
        pytest.approx(np.mean([per_ray[i] for i in (0, 2, 3)]), rel=1e-5)


def test_psnr_matches_jax():
    b = _ray_batch(4)
    assert float(psnr(t(b["rgb"]), t(b["rgb_gt"]))) == pytest.approx(
        float(jM.psnr(b["rgb"], b["rgb_gt"])), rel=1e-6)


@pytest.mark.parametrize("step", [0, 19999, 20000, 45000, 300000])
def test_lr_values_match_jax(step):
    fake = SimpleNamespace(config=SimpleNamespace(optimizers={
        "fields": JaxOptimizerConfig(lr=5e-3, scheduler_gamma=0.8),
        "deformation_field": JaxOptimizerConfig(lr=1e-3, scheduler_gamma=0.5),
        "embeddings": JaxOptimizerConfig(lr=5e-3, scheduler_gamma=0.8)}))
    theirs = JaxTrainer.lr_values(fake, step)
    ours = lr_values(default_optimizers(), step)
    assert ours == {k: float(v) for k, v in theirs.items()}


def test_quantized_budget_matches_jax():
    for measured in (0, 100, 5000, 63188, 70000, 2e6):
        for current in (None, 8192, 73728, 98304):
            assert tsamp.quantized_budget(measured, 4096, 256, current=current) \
                == jsamp.quantized_budget(measured, 4096, 256, current=current)
    assert tsamp.quantized_budget(63188, 4096, 256) == 73728


def test_march_rays_with_jitter_matches_jax():
    from torch_parity import example_rays
    rays = example_rays(96, 8, seed=5)
    rng = np.random.default_rng(6)
    occ = rng.uniform(size=(16, 16, 16)) < 0.3
    jitter = rng.uniform(size=96).astype(np.float32)
    lo, hi = np.array([-2.5, -2.0, -2.5], np.float32), np.array([2.5, 3.0, 2.0], np.float32)
    theirs, j_info = jsamp.march_rays(
        jnp.asarray(rays["origins"]), jnp.asarray(rays["directions"]),
        jnp.asarray(lo), jnp.asarray(hi), 0.011, 768, 64,
        binaries=jnp.asarray(occ), near_plane=0.2, far_plane=1e3,
        jitter=jnp.asarray(jitter))
    ours, info = tsamp.march_rays(
        t(rays["origins"]), t(rays["directions"]), t(lo), t(hi), 0.011, 768,
        64, binaries=t(occ), near_plane=0.2, far_plane=1e3, jitter=t(jitter))
    mask = n(theirs.mask)
    assert mask.sum() > 100 and not mask.all()
    np.testing.assert_array_equal(n(ours.mask), mask)
    np.testing.assert_array_equal(n(info["n_samples_per_ray"]),
                                  n(j_info["n_samples_per_ray"]))
    for a, b in ((ours.t_starts, theirs.t_starts), (ours.t_ends, theirs.t_ends)):
        np.testing.assert_allclose(n(a)[mask], n(b)[mask], rtol=1e-6)


# -- fused MLP backward (B2's plain version) -------------------------------------

MODEL_MLPS = {  # (in, out, layers, width, skips, bias, out_act)
    "stem": (173, 128, 6, 128, (4,), True, "relu"),
    "base": (32, 16, 2, 64, (), False, None),
    "head": (18, 3, 3, 64, (), False, "sigmoid"),
}


@pytest.fixture
def interpret_mode():
    jfm.INTERPRET = True
    yield
    jfm.INTERPRET = False


def _mlp_bwd_case(shape, dtype, rows=700):
    """Port params, x and g (positive_ for bf16: no relu sign depends on
    rounding and no sum cancels, see ops/fused_mlp.py), and the Pallas
    backward's (dx, dWs, dbs) for the same values. 700 rows: not a multiple
    of the 512-row tile."""
    d_in, d_out, n_layers, width, skips, bias, act = MODEL_MLPS[shape]
    gen = torch.Generator().manual_seed(11)
    params = ParamTree(init_mlp(gen, d_in, d_out, n_layers, width, skips, bias))
    if dtype == "bfloat16":
        tfm.positive_(params, gen)
        x = tfm.positive_input(rows, d_in, gen)
        g = tfm.positive_input(rows, d_out, gen)
    else:
        x = torch.randn(rows, d_in, generator=gen)
        g = torch.randn(rows, d_out, generator=gen)
    jparams = jax.tree_util.tree_map(jnp.asarray, to_tree(params, n))
    _, vjp = jax.vjp(lambda p, xx: jfm.fused_mlp_apply(
        p, xx, out_activation=act, compute_dtype=jnp.dtype(dtype),
        skip_connections=skips), jparams, jnp.asarray(n(x)))
    dp, dx = vjp(jnp.asarray(n(g)))
    layers = dp["layers"]
    theirs = (t(dx), [t(layer["w"]) for layer in layers],
              [t(layer["b"]) for layer in layers] if bias else None)
    return params, x, g, theirs, (act, skips)


@pytest.mark.parametrize("shape", sorted(MODEL_MLPS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_bwd_plain_matches_pallas(interpret_mode, shape, dtype):
    """dx, every dW and db of fused_mlp_bwd_plain vs the Pallas backward
    kernel (interpret mode), within B2's bound (fused_mlp.compare_bwd_to_plain:
    max error <= 1e-3 of max |ref|, mean error <= 1e-5 of mean |ref|)."""
    params, x, g, theirs, (act, skips) = _mlp_bwd_case(shape, dtype)
    ours = tfm.fused_mlp_bwd_plain(params, x, g, act, getattr(torch, dtype), skips)
    tfm.compare_bwd_to_plain(ours, theirs)
    # the same through the autograd Function the model calls
    p = params_from_numpy(to_tree(params, n), "cpu")
    for q in p.parameters():
        q.requires_grad_(True)
    xt = x.clone().requires_grad_(True)
    tfm.fused_mlp_apply(p, xt, act, getattr(torch, dtype), skips).backward(g)
    layers = p.layers
    tfm.compare_bwd_to_plain(
        (xt.grad, [layer.w.grad for layer in layers],
         [layer.b.grad for layer in layers] if "b" in layers[0] else None), theirs)


@pytest.mark.parametrize("shape", sorted(MODEL_MLPS))
def test_autograd_through_round_to_fails_the_bwd_bound(interpret_mode, shape):
    """Autograd of the plain forward (through ``round_to``) takes dh from
    the bf16-rounded weights and rounds the hidden gradients to bf16: a
    different function from the kernel's, which B2's bound rejects."""
    params, x, g, theirs, (act, skips) = _mlp_bwd_case(shape, "bfloat16")
    for q in params.parameters():
        q.requires_grad_(True)
    xt = x.clone().requires_grad_(True)
    tfm.fused_mlp_plain(params, xt, act, torch.bfloat16, skips).backward(g)
    layers = params.layers
    variant = (xt.grad, [layer.w.grad for layer in layers],
               [layer.b.grad for layer in layers] if "b" in layers[0] else None)
    with pytest.raises(AssertionError):
        tfm.compare_bwd_to_plain(variant, theirs)


def test_bwd_layout_splits_the_partial_sum():
    """csrc/fused_mlp_bwd.cu's partial layout (every dW_i as [out][in] at
    its offset, then every db_i), filled from the plain gradients and split
    by the wrapper's ``split_partial_sum``, gives them back."""
    d_in, d_out, n_layers, width, skips, bias, act = MODEL_MLPS["stem"]
    gen = torch.Generator().manual_seed(12)
    params = ParamTree(init_mlp(gen, d_in, d_out, n_layers, width, skips, bias))
    x, g = torch.randn(50, d_in, generator=gen), torch.randn(50, d_out, generator=gen)
    _, dws, dbs = tfm.fused_mlp_bwd_plain(params, x, g, act, torch.bfloat16, skips)
    wf, per_layer, stride = tfm.bwd_layout(params, d_in, skips)
    total = torch.full((stride,), float("nan"))
    for (in_real, out_real, hw, w_off, b_off), dw, db, layer in zip(
            per_layer, dws, dbs, params.layers):
        assert torch.equal(wf[w_off:w_off + in_real * out_real],
                           layer.w.reshape(-1))
        total[w_off:w_off + in_real * out_real] = dw.t().reshape(-1)
        total[b_off:b_off + out_real] = db
    assert stride % 4 == 0
    got_w, got_b = tfm.split_partial_sum(total, per_layer, True)
    assert all(torch.equal(a, b) for a, b in zip(got_w, dws))
    assert all(torch.equal(a, b) for a, b in zip(got_b, dbs))
    _, _, per_layer_fwd, kx, h_stride, _, _ = tfm.pack_weights(params, d_in, skips)
    assert tfm.bwd_smem_bytes(per_layer_fwd, kx, h_stride) <= tfm._SMEM_LIMIT


# -- quad fold (B4's plain version) ------------------------------------------------

def _bits(x):
    return (x.view(torch.int16).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x).view(np.int16))


@pytest.mark.parametrize("layout,width", [
    ((4, 10, 4, 1.5), 16),                 # the tiny flagship layout
    ((7, 19, 16, 1.4472692012786865), 8),  # the flagship's first 7 levels
])
def test_quad_fold_plain_is_bit_equal_to_xla(layout, width):
    lv = jhe.HashGridLevels.create(*layout)
    ours_lv = HashGridLevels.create(*layout)
    assert any(lv.hashed) and not all(lv.hashed)
    assert ours_lv.offsets == lv.offsets and ours_lv.sizes == lv.sizes
    g = np.random.default_rng(13).standard_normal(
        (lv.total_entries, 4 * width)).astype(np.float32)
    theirs = jhe._quad_bwd_xla(jnp.asarray(g).astype(jnp.bfloat16), lv)
    ours = quad_kernel.quad_fold(t(g).to(torch.bfloat16), ours_lv)
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))


def test_quad_build_gradient_is_the_jax_vjp():
    """Autograd through quad_build (fold in its backward) == jax.vjp of
    quad_from_cast, bit for bit, on the tiny layout in bf16."""
    cfg = __graft_entry__._flagship_model_config(tiny=True)
    lv = jax_build_levels(cfg)
    ours_lv = HashGridLevels.create(4, 10, 4, 1.5)
    rng = np.random.default_rng(14)
    table = rng.standard_normal((lv.total_entries, 16)).astype(np.float32)
    cot = rng.standard_normal((lv.total_entries, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda tb: jhe.quad_from_cast(tb, lv),
                     jnp.asarray(table).astype(jnp.bfloat16))
    (theirs,) = vjp(jnp.asarray(cot).astype(jnp.bfloat16))
    tt = t(table).to(torch.bfloat16).requires_grad_(True)
    quad_kernel.quad_build(tt, ours_lv).backward(t(cot).to(torch.bfloat16))
    np.testing.assert_array_equal(_bits(tt.grad), _bits(theirs))


# -- Adam ------------------------------------------------------------------------

def test_fused_adam_update_matches_jax_over_three_groups():
    rng = np.random.default_rng(15)
    tree = {"field": {"table": rng.normal(size=(64, 8)),
                      "mlp_base": {"layers": [{"w": rng.normal(size=(8, 4))}]}},
            "deformation": {"stem": {"layers": [{"w": rng.normal(size=(5, 3)),
                                                 "b": rng.normal(size=(3,))}]}},
            "time_embedding": rng.normal(size=(8, 4))}
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    groups = {"fields": ["field"], "deformation_field": ["deformation"],
              "embeddings": ["time_embedding"]}
    lrs = {"fields": 5e-3, "deformation_field": 1e-3, "embeddings": 4e-3}
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_state = optax.scale_by_adam(eps=1e-15).init(j_params)
    ours = params_from_numpy(tree, "cpu")
    state = init_adam(ours)
    key_to_group = group_of_param(groups)
    for step in range(4):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) * 10.0 ** rng.integers(-6, 1))
            .astype(np.float32), tree)
        j_params, j_state = j_adam(
            j_params, jax.tree_util.tree_map(jnp.asarray, grads), j_state,
            key_to_group, {k: np.float32(v) for k, v in lrs.items()})
        for name, p in ours.named_parameters():
            p.grad = params_from_numpy(grads, "cpu").get_parameter(name).detach().clone()
        state = fused_adam_update(ours, state, key_to_group, lrs)
    assert int(state.count) == int(j_state.count) == 4
    for mine, theirs in ((ours, j_params), (state.mu, j_state.mu),
                         (state.nu, j_state.nu)):
        ref = params_from_numpy(jax.tree_util.tree_map(np.asarray, theirs), "cpu")
        for name, value in mine.named_parameters():
            np.testing.assert_allclose(n(value), n(ref.get_parameter(name)),
                                       rtol=2e-6, atol=1e-12, err_msg=name)


# the Adam kernel's segment plan: (p, g, mu, nu) element offsets from
# 512-byte-aligned allocations, numel, the gradient's element size; the
# expected (start, count, vector) segments
_BASE = 1 << 20
PLAN_CASES = [
    ((0, 0, 0, 0), 4096, 4, [(0, 4096, True)]),
    ((0, 0, 0, 0), 4099, 4, [(0, 4096, True), (4096, 3, False)]),
    ((0, 0, 0, 0), 3, 4, [(0, 3, False)]),
    ((0, 0, 0, 0), 1, 4, [(0, 1, False)]),
    # a row shard of rows 2 wide starting at an odd row, moments and
    # gradient shifted alike: head, body, tail
    ((2, 2, 2, 2), 1001, 4, [(0, 2, False), (2, 996, True), (998, 3, False)]),
    ((1, 1, 1, 1), 12, 4, [(0, 3, False), (3, 8, True), (11, 1, False)]),
    ((3, 3, 3, 3), 2, 4, [(0, 2, False)]),
    # the moments-only row shard: p at an odd row of the 2-feature table,
    # moments and gradient of the shard aligned: one scalar segment
    ((2, 0, 0, 0), 1000, 4, [(0, 1000, False)]),
    # a gradient viewed out of a flat all-reduce buffer
    ((0, 6, 0, 0), 64, 4, [(0, 64, False)]),
    ((0, 0, 1, 0), 64, 4, [(0, 64, False)]),
    # bf16 gradients: 4 elements are 8 bytes
    ((0, 0, 0, 0), 4098, 2, [(0, 4096, True), (4096, 2, False)]),
    ((0, 4, 0, 0), 64, 2, [(0, 64, True)]),
    ((0, 2, 0, 0), 64, 2, [(0, 64, False)]),
    ((1, 1, 1, 1), 9, 2, [(0, 3, False), (3, 4, True), (7, 2, False)]),
    ((0, 0, 0, 0), 0, 4, []),
]


@pytest.mark.parametrize("offsets,numel,g_bytes,expected", PLAN_CASES)
def test_adam_plan_covers_every_element_once(offsets, numel, g_bytes, expected):
    from nersemble_tpu_torch.ops import fused_adam

    po, go, mo, vo = offsets
    leaf = (_BASE + 4 * po, 3 * _BASE + g_bytes * go, 5 * _BASE + 4 * mo,
            7 * _BASE + 4 * vo, numel, g_bytes)
    other = (9 * _BASE, 11 * _BASE, 13 * _BASE, 15 * _BASE, 8, 4)
    plan = fused_adam.plan_segments([other, leaf])
    assert plan[0] == fused_adam.Segment(0, 0, 8, True)
    mine = [s for s in plan if s.leaf == 1]
    assert [(s.start, s.count, s.vector) for s in mine] == expected
    covered = np.zeros(numel, np.int64)
    for s in mine:
        assert s.count > 0
        covered[s.start:s.start + s.count] += 1
        if s.vector:
            assert s.count % 4 == 0
            for addr, size in ((leaf[0], 4), (leaf[2], 4), (leaf[3], 4)):
                assert (addr + size * s.start) % fused_adam.VECTOR_BYTES == 0
            assert (leaf[1] + g_bytes * s.start) % (4 * g_bytes) == 0
    assert (covered == 1).all()
    # around a body, a head up to p's first 16-byte boundary and a tail,
    # each under 4 elements
    vec = [i for i, s in enumerate(mine) if s.vector]
    if vec:
        (body,) = vec
        assert all(s.count < 4 for i, s in enumerate(mine) if i != body)
        assert (leaf[0] + 4 * mine[body].start) % 16 == 0 and mine[body].start < 4


def test_adam_update_takes_the_plain_path_on_cpu():
    from nersemble_tpu_torch.ops import fused_adam

    rng = np.random.default_rng(3)
    leaves, ref = [], []
    for shape, dtype, lr in (((37, 5), torch.float32, 5e-3), ((11,), torch.bfloat16, 1e-3)):
        p, mu = (t(rng.normal(size=shape).astype(np.float32)) for _ in range(2))
        nu = t(rng.uniform(size=shape).astype(np.float32))
        g = t(rng.normal(size=shape).astype(np.float32)).to(dtype)
        leaves.append((p, g, mu, nu, lr))
        ref.append(tuple(x.clone() for x in (p, g, mu, nu)) + (lr,))
    c1, c2 = torch.tensor(0.271), torch.tensor(0.00299)
    before = fused_adam.LAUNCHES
    fused_adam.adam_update(leaves, c1, c2, 0.9, 0.999, 1e-15)
    assert fused_adam.LAUNCHES == before
    for (p, _, mu, nu, _), (rp, rg, rmu, rnu, lr) in zip(leaves, ref):
        fused_adam.adam_update_plain(rp, rg, rmu, rnu, lr, c1, c2, 0.9, 0.999, 1e-15)
        for mine, theirs in ((p, rp), (mu, rmu), (nu, rnu)):
            assert torch.equal(mine, theirs)
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam.adam_update_cuda(leaves, c1, c2, 0.9, 0.999, 1e-15)


# -- occupancy ---------------------------------------------------------------------

def _occ_density(positions, timesteps, lib):
    """A smooth stand-in for density * step, written for both frameworks."""
    p = positions
    return (lib.sin(3.0 * p[:, 0]) * lib.cos(2.0 * p[:, 1]) + p[:, 2]) ** 2 \
        * (1.0 + timesteps.astype(np.float32) if lib is jnp
           else 1.0 + timesteps.to(torch.float32)) * 0.01


@pytest.mark.parametrize("warmup", [True, False])
def test_update_occupancy_grid_matches_jax_with_injected_draws(warmup):
    G, n_t, thre, decay = 8, 8, 0.01, 0.95
    lo, hi = np.array([-1.0, -0.5, -2.0], np.float32), np.array([1.0, 1.5, 0.0], np.float32)
    occs = np.random.default_rng(16).uniform(0, 0.03, G ** 3).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    # the draws of nersemble_tpu/ops/occupancy.update_occupancy_grid
    pos_rng, time_rng, uni_rng, occ_rng = jax.random.split(rng, 4)
    m = G ** 3 // 4
    n_probe = G ** 3 if warmup else 2 * m
    draws = tocc.OccupancyDraws(
        cell_jitter=t(jax.random.uniform(pos_rng, (n_probe, 3))),
        timesteps=t(jax.random.randint(time_rng, (n_probe,), 0, n_t)).long(),
        uniform_idx=None if warmup else t(jax.random.randint(
            uni_rng, (m,), 0, G ** 3, jnp.int32)).long(),
        occupied_u=None if warmup else t(jax.random.uniform(occ_rng, (m,))))

    def j_eval(positions, time_rng_):
        ts = jax.random.randint(time_rng_, (positions.shape[0],), 0, n_t)
        return _occ_density(positions, ts, jnp)

    theirs = n(jocc.update_occupancy_grid(jnp.asarray(occs), j_eval, rng, G,
                                          jnp.asarray(lo), jnp.asarray(hi),
                                          thre, decay, warmup))
    candidates = {}

    def t_eval(positions, timesteps):
        val = _occ_density(positions, timesteps, torch)
        candidates["val"] = val
        return val

    ours = n(tocc.update_occupancy_grid(t(occs), t_eval, draws, G, t(lo), t(hi),
                                        thre, decay, warmup))
    # the probed cells as the port draws them == JAX's
    idx = np.arange(G ** 3) if warmup else np.concatenate([
        n(draws.uniform_idx), n(tocc._sample_occupied_cells(
            draws.occupied_u, t(occs) > min(occs.mean(), thre)))])
    counts = np.bincount(idx, minlength=G ** 3)
    single = counts <= 1
    assert (counts > 1).any() != warmup
    np.testing.assert_allclose(ours[single], theirs[single], rtol=1e-5, atol=1e-9)
    # a cell probed twice or more takes its largest candidate here; XLA keeps
    # one of them
    cand = np.maximum(occs[idx] * decay, n(candidates["val"]))
    for cell in np.nonzero(counts > 1)[0]:
        best = cand[idx == cell].max()
        assert ours[cell] == pytest.approx(best, rel=1e-5)
        assert theirs[cell] <= best * (1 + 1e-5)
