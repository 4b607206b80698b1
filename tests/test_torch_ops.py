"""PyTorch port vs the JAX package: leaf ops, MLPs, quad build, hash encoding.

Inputs come from numpy seeds and cross as numpy. Tolerances: float32 paths
differ only in summation order and libm ulps (rtol 1e-5 unless stated);
copies and integer index math are compared exactly.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, t, to_numpy_tree

import __graft_entry__
from nersemble_tpu.engine.trainer import NeRSembleTrainer
from nersemble_tpu.models.field import build_levels as jax_build_levels
from nersemble_tpu.ops import fused_mlp as jfm
from nersemble_tpu.ops import hash_encoding as jhe
from nersemble_tpu.ops import quad_pallas
from nersemble_tpu.ops.hash_ensemble import effective_blend_code as j_blend
from nersemble_tpu.ops.mlp import apply_mlp as j_apply_mlp
from nersemble_tpu.ops.mlp import init_mlp as j_init_mlp
from nersemble_tpu.ops.posenc import windowed_posenc as j_posenc
from nersemble_tpu.ops.sh import shift_directions as j_shift
from nersemble_tpu.ops.trunc_exp import trunc_exp as j_trunc_exp
from nersemble_tpu.utils.se3 import se3_apply as j_se3_apply
from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.engine.checkpoints import params_from_numpy
from nersemble_tpu_torch.ops import fused_mlp as tfm
from nersemble_tpu_torch.ops import hash_encoding as the
from nersemble_tpu_torch.ops import quad_kernel
from nersemble_tpu_torch.ops.hash_ensemble import effective_blend_code
from nersemble_tpu_torch.ops.mlp import activate, apply_mlp, init_mlp, round_to
from nersemble_tpu_torch.ops.posenc import windowed_posenc
from nersemble_tpu_torch.ops.sh import shift_directions
from nersemble_tpu_torch.ops.trunc_exp import trunc_exp
from nersemble_tpu_torch.utils.params import ParamTree
from nersemble_tpu_torch.utils.se3 import se3_apply
from nersemble_tpu_torch.utils.windows import sched_values

F32 = dict(rtol=1e-5, atol=1e-6)


# -- leaf ops ----------------------------------------------------------------

def test_trunc_exp():
    x = np.random.default_rng(0).normal(size=(257,)).astype(np.float32) * 4
    np.testing.assert_allclose(n(trunc_exp(t(x))), n(j_trunc_exp(x)), **F32)


@pytest.mark.parametrize("window", [None, 0.0, 2.5, 7.0])
def test_windowed_posenc(window):
    x = np.random.default_rng(1).uniform(size=(300, 3)).astype(np.float32)
    ours = windowed_posenc(t(x), 7, 0.0, 6.0, True, window)
    theirs = j_posenc(x, 7, 0.0, 6.0, True,
                      None if window is None else np.float32(window))
    assert ours.shape == (300, 45)
    np.testing.assert_allclose(n(ours), n(theirs), rtol=1e-5, atol=2e-6)


def test_shift_directions():
    d = np.random.default_rng(2).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(n(shift_directions(t(d))), n(j_shift(d)), **F32)


@pytest.mark.parametrize("r_scale", [1e-6, 1e-2, 1.0])
def test_se3_apply(r_scale):
    """r_scale 1e-6 puts |r|^2 under the 1e-8 Taylor threshold. atol 5e-5:
    (t - sin t) / t^3 cancels for small t, so one-ulp libm differences in
    sin grow to ~1e-5 on O(1) points."""
    rng = np.random.default_rng(3)
    screw = rng.normal(size=(400, 6)).astype(np.float32)
    screw[:, 3:] *= r_scale
    p = rng.normal(size=(400, 3)).astype(np.float32)
    np.testing.assert_allclose(n(se3_apply(t(screw), t(p))),
                               n(j_se3_apply(screw, p)), rtol=1e-5, atol=5e-5)


@pytest.mark.parametrize("window", [None, 0.5, 1.0, 1.4, 2.0, 5.3, 8.0])
@pytest.mark.parametrize("disable_initial,soft", [(True, True), (False, True),
                                                  (True, False),
                                                  (False, False)])
def test_effective_blend_code(window, disable_initial, soft):
    code = np.random.default_rng(4).normal(size=(33, 8)).astype(np.float32)
    w = None if window is None else np.float32(window)
    ours = effective_blend_code(t(code), w, 8, disable_initial, soft)
    theirs = j_blend(code, w, 8, disable_initial, soft)
    np.testing.assert_allclose(n(ours), n(theirs), **F32)


@pytest.mark.parametrize("step", [0, 10000, 20000, 50000, 80000, 90000])
def test_sched_values(step):
    cfg = flagship_model_config(False)
    jax_cfg = __graft_entry__._flagship_model_config(False)
    fake = SimpleNamespace(config=SimpleNamespace(model=jax_cfg))
    theirs = NeRSembleTrainer.sched_values(fake, step)
    ours = sched_values(cfg, step)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key] == float(theirs[key])


# -- MLPs ---------------------------------------------------------------------

CASES = [
    # (in, out, layers, width, skips, bias, out_act): tests/test_fused_mlp.py
    # shapes, plus a narrow 6-layer stem with the skip at layer 4
    ("field_base", 32, 16, 2, 64, (), False, None),
    ("color_head", 18, 3, 3, 64, (), False, "sigmoid"),
    ("deform_stem", 45 + 16, 32, 4, 32, (2,), True, "relu"),
    ("narrow_stem", 45 + 16, 16, 6, 16, (4,), True, "relu"),
]


def _mlp_case(d_in, d_out, n_layers, width, skips, bias, rows=700):
    params = to_numpy_tree(j_init_mlp(jax.random.PRNGKey(0), d_in, d_out,
                                      n_layers, width, skip_connections=skips,
                                      bias=bias))
    x = np.random.default_rng(5).normal(size=(rows, d_in)).astype(np.float32)
    return params, x


@pytest.fixture
def interpret_mode():
    jfm.INTERPRET = True
    yield
    jfm.INTERPRET = False


@pytest.mark.parametrize("name,d_in,d_out,n_layers,width,skips,bias,out_act",
                         CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_plain_matches_pallas(interpret_mode, name, d_in, d_out,
                                        n_layers, width, skips, bias, out_act,
                                        dtype):
    """The port's plain version vs the Pallas kernel in interpret mode.
    bf16: the two frameworks sum the f32 products in different orders, so a
    hidden activation can round to the neighbouring bf16 value (2^-8
    relative) — hence rtol/atol 1e-2 there; f32 is held to 1e-5."""
    params, x = _mlp_case(d_in, d_out, n_layers, width, skips, bias)
    theirs = jfm.fused_mlp_apply(params, x, out_activation=out_act,
                                 compute_dtype=jnp.dtype(dtype),
                                 skip_connections=skips)
    ours = tfm.fused_mlp_apply(params_from_numpy(params, "cpu"), t(x), out_act,
                               getattr(torch, dtype), skips)
    tol = dict(rtol=1e-5, atol=2e-5) if dtype == "float32" \
        else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(n(ours), n(theirs), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mlp(dtype):
    params, x = _mlp_case(45 + 16, 32, 4, 32, (2,), True)
    theirs = j_apply_mlp(params, x, out_activation=jax.nn.relu,
                         compute_dtype=jnp.dtype(dtype), skip_connections=(2,))
    ours = apply_mlp(params_from_numpy(params, "cpu"), t(x), "relu",
                     getattr(torch, dtype), (2,))
    tol = F32 if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(n(ours), n(theirs), **tol)


@pytest.mark.parametrize("name,d_in,d_out,n_layers,width,skips,bias,out_act",
                         CASES)
def test_fused_mlp_plain_equals_apply_mlp(name, d_in, d_out, n_layers, width,
                                          skips, bias, out_act):
    """The unfused chain rounds at the same points, so the port needs one
    MLP path (``use_fused_mlp=False`` is rejected, not a second route)."""
    params, x = _mlp_case(d_in, d_out, n_layers, width, skips, bias)
    p = params_from_numpy(params, "cpu")
    assert torch.equal(apply_mlp(p, t(x), out_act, torch.bfloat16, skips),
                       tfm.fused_mlp_plain(p, t(x), out_act, torch.bfloat16, skips))


def _emulate_fused_kernel(params, x, out_act, skips):
    """csrc/fused_mlp_fwd.cu's arithmetic on the packed operands the wrapper
    hands it (padded transposed bf16 blocks, K split into hidden and input
    segments), in float32 on the CPU."""
    wt, bias, per_layer, kx, _, d_out, _ = tfm.pack_weights(params, x.shape[1],
                                                            skips)
    xs = torch.zeros(x.shape[0], kx)
    xs[:, :x.shape[1]] = round_to(x, torch.bfloat16)
    h = None
    n_layers = len(per_layer) // 5
    for i in range(n_layers):
        n_i, kh, kxl, w_off, b_off = per_layer[5 * i:5 * i + 5]
        w = wt[w_off:w_off + n_i * (kh + kxl)].view(n_i, kh + kxl).float()
        inp = torch.cat(([h[:, :kh]] if kh else []) + ([xs[:, :kxl]] if kxl else []),
                        dim=1)
        pre = inp @ w.t() + bias[b_off:b_off + n_i]
        if i < n_layers - 1:
            h = round_to(torch.relu(pre), torch.bfloat16)
        else:
            out = pre[:, :d_out]
    return {None: out, "relu": torch.relu(out), "sigmoid": torch.sigmoid(out)}[out_act]


@pytest.mark.parametrize("name,d_in,d_out,n_layers,width,skips,bias,out_act",
                         CASES + [("flagship_stem", 173, 128, 6, 128, (4,),
                                   True, "relu")])
def test_fused_mlp_kernel_packing(name, d_in, d_out, n_layers, width, skips,
                                  bias, out_act):
    """The kernel's operand packing (zero padding, transposition, the skip
    layer's K split) computes the plain chain, within the kernel's stated
    tolerance (``fused_mlp.compare_to_plain``)."""
    params, x = _mlp_case(d_in, d_out, n_layers, width, skips, bias, rows=300)
    p = params_from_numpy(params, "cpu")
    ours = _emulate_fused_kernel(p, t(x), out_act, skips)
    plain = tfm.fused_mlp_plain(p, t(x), out_act, torch.bfloat16, skips)
    tfm.compare_to_plain(ours, plain)
    _, _, per_layer, kx, _, _, _ = tfm.pack_weights(p, d_in, skips)
    assert tfm.fwd_layout(per_layer, d_in, kx)["smem_bytes"] + 1024 <= tfm._SMEM_LIMIT


def _mlp_variant(params, x, out_act, skips, round_x=True, round_hidden=True,
                 f64_sums=False):
    """The plain chain with one of its bf16 rounding points left out, or with
    its f32 sums taken in float64 (another summation order)."""
    x_in = round_to(x, torch.bfloat16) if round_x else x
    h = x_in
    layers = params.layers
    for i, layer in enumerate(layers):
        if i in skips and i > 0:
            h = torch.cat([h, x_in], dim=-1)
        w = round_to(layer.w, torch.bfloat16)
        pre = (h.double() @ w.double()).float() if f64_sums else h @ w
        if "b" in layer:
            pre = pre + layer.b
        if i < len(layers) - 1:
            h = torch.relu(pre)
            h = round_to(h, torch.bfloat16) if round_hidden else h
        else:
            h = activate(pre, out_act)
    return h


FLAGSHIP_MLPS = {  # (in, out, layers, width, skips, bias, out_act)
    "stem": (173, 128, 6, 128, (4,), True, "relu"),
    "base": (32, 16, 2, 64, (), False, None),
    "head": (18, 3, 3, 64, (), False, "sigmoid"),
}


@pytest.mark.parametrize("shape", sorted(FLAGSHIP_MLPS))
@pytest.mark.parametrize("variant,passes", [
    (dict(f64_sums=True), True),
    (dict(round_x=False), False),
    (dict(round_hidden=False), False),
])
def test_fused_mlp_tolerance_tells_sum_order_from_missing_rounding(
        shape, variant, passes):
    """The kernel-vs-plain tolerance at the flagship shapes admits another
    f32 summation order and rejects a chain that skips a bf16 rounding
    point (of x, or of the hidden activations)."""
    d_in, d_out, n_layers, width, skips, bias, out_act = FLAGSHIP_MLPS[shape]
    g = torch.Generator().manual_seed(0)
    params = ParamTree(init_mlp(g, d_in, d_out, n_layers, width, skips, bias))
    x = torch.randn(16384, d_in, generator=g)
    plain = tfm.fused_mlp_plain(params, x, out_act, torch.bfloat16, skips)
    out = _mlp_variant(params, x, out_act, set(skips), **variant)
    if passes:
        tfm.compare_to_plain(out, plain)
    else:
        with pytest.raises(AssertionError):
            tfm.compare_to_plain(out, plain)


def test_fused_mlp_cuda_wrapper_rejects_cpu_tensors():
    params, x = _mlp_case(32, 16, 2, 64, (), False)
    with pytest.raises(ValueError):
        tfm.fused_mlp_cuda(params_from_numpy(params, "cpu"), t(x))


# -- quad build ----------------------------------------------------------------

def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def test_quad_build_plain_matches_pallas_build():
    """tests/test_ops.py's layout: a padded dense level plus hashed levels
    of exactly one 2048-row block."""
    lv = jhe.HashGridLevels.create(n_levels=6, log2_hashmap_size=12,
                                   base_resolution=4, per_level_scale=1.5)
    ours_lv = the.HashGridLevels.create(6, 12, 4, 1.5)
    table = np.random.default_rng(6).standard_normal(
        (lv.total_entries, 8)).astype(np.float32)
    quad_pallas.INTERPRET = True
    try:
        theirs = quad_pallas.build(jnp.asarray(table).astype(jnp.bfloat16), lv)
    finally:
        quad_pallas.INTERPRET = False
    ours = quad_kernel.quad_build(t(table).to(torch.bfloat16), ours_lv)
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))


def test_quad_build_plain_matches_xla_on_tiny_flagship_layout():
    cfg = __graft_entry__._flagship_model_config(tiny=True)
    lv = jax_build_levels(cfg)
    ours_lv = the.HashGridLevels.create(**_level_args(cfg))
    table = np.random.default_rng(7).standard_normal(
        (lv.total_entries, 16)).astype(np.float32)
    theirs = jhe._quad_fwd_xla(jnp.asarray(table).astype(jnp.bfloat16), lv)
    ours = quad_kernel.quad_build(t(table).to(torch.bfloat16), ours_lv)
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))


@pytest.mark.parametrize("tiny", [True, False])
def test_quad_kernel_layout_indexing(tiny):
    """csrc/quad_build.cu's source-row arithmetic over the wrapper's layout
    argument, emulated in numpy, equals the plain build."""
    lv = the.HashGridLevels.create(**_level_args(flagship_model_config(tiny)))
    meta = quad_kernel.kernel_layout(lv)
    L = meta[0]
    offsets = np.array(meta[1:1 + L])
    sizes = np.array(meta[1 + L:1 + 2 * L])
    shifts = np.array(meta[1 + 2 * L:]).reshape(3, L)
    rows = np.arange(lv.total_entries)
    level = np.searchsorted(offsets, rows, side="right") - 1
    table = np.arange(lv.total_entries, dtype=np.int64)
    cols = [table]
    for q in range(3):
        r = rows - offsets[level] + shifts[q, level]
        r = np.where(r >= sizes[level], r - sizes[level], r)
        cols.append(table[offsets[level] + r])
    emulated = np.stack(cols, axis=1)
    plain = quad_kernel.quad_build_plain(torch.from_numpy(table)[:, None], lv)
    np.testing.assert_array_equal(emulated, plain.numpy())


# -- hash encoding ---------------------------------------------------------------

def _level_args(cfg):
    hc = cfg.hash_ensemble.hash_encoding
    return dict(n_levels=hc.n_levels, log2_hashmap_size=hc.log2_hashmap_size,
                base_resolution=hc.base_resolution,
                per_level_scale=hc.per_level_scale)


@pytest.mark.parametrize("tiny", [True, False])
def test_hash_grid_levels_match(tiny):
    cfg = __graft_entry__._flagship_model_config(tiny)
    assert dataclasses.asdict(the.HashGridLevels.create(**_level_args(cfg))) \
        == dataclasses.asdict(jax_build_levels(cfg))


@pytest.mark.parametrize("tiny", [True, False])
def test_hash_grid_indices_match(tiny):
    cfg = __graft_entry__._flagship_model_config(tiny)
    lv = jax_build_levels(cfg)
    assert any(lv.hashed)
    x = np.random.default_rng(8).uniform(size=(513, 3)).astype(np.float32)
    theirs = jhe.hash_grid_indices(x, lv)
    ours = the.hash_grid_indices(t(x), the.HashGridLevels.create(**_level_args(cfg)))
    np.testing.assert_array_equal(n(ours[0]), n(theirs[0]).astype(np.int64))
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-6)


def _blend_case(dtype):
    cfg = __graft_entry__._flagship_model_config(tiny=True)
    lv = jax_build_levels(cfg)
    rng = np.random.default_rng(9)
    quad = rng.normal(size=(lv.total_entries, 4 * 16)).astype(np.float32)
    x = rng.uniform(size=(300, 3)).astype(np.float32)
    code = rng.normal(size=(300, 8)).astype(np.float32)
    j_quad = jnp.asarray(quad).astype(dtype)
    ours = the.hash_encode_blended(t(quad).to(getattr(torch, dtype)), t(x),
                                   t(code), the.HashGridLevels.create(**_level_args(cfg)))
    return ours, j_quad, x, code, lv


def test_hash_encode_blended_f32():
    ours, j_quad, x, code, lv = _blend_case("float32")
    assert ours.shape == (300, 8)
    np.testing.assert_allclose(n(ours), n(jhe.hash_encode_blended(j_quad, x, code, lv)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        n(ours), n(jhe.hash_encode_blended_reference(j_quad, x, code, lv)),
        rtol=1e-5, atol=1e-5)


def test_hash_encode_blended_bf16():
    """Both sides round rows * code to bf16 and sum in f32; the sums run in
    different orders (JAX: selection-matrix matmuls), so the looser
    tolerance covers f32 reassociation over 2L*4*H ~ 256 terms of ~1."""
    ours, j_quad, x, code, lv = _blend_case("bfloat16")
    np.testing.assert_allclose(n(ours), n(jhe.hash_encode_blended(j_quad, x, code, lv)),
                               rtol=1e-4, atol=1e-4)
