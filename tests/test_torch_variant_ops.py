"""The modules of the model's other configurations: the port vs the JAX
package, op by op (CPU).

SH direction encoding, the plain single-grid encode (values and gradients
to the table and to x), the cone-angle comb, ``march_rays`` with a cone
angle, ``coarse_entry_steps``, the candidate count that spans the box under
a cone angle, the early-stop suffix drop, and the quad build and fold at the
single grid's 2-feature rows. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, t

import __graft_entry__
from nersemble_tpu.models.nersemble import NeRSembleModel as JaxModel
from nersemble_tpu.ops import hash_encoding as jhe
from nersemble_tpu.ops import sampling as jsm
from nersemble_tpu.ops import sh as jsh
from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.models.nersemble import NeRSembleModel
from nersemble_tpu_torch.ops import hash_encoding as the
from nersemble_tpu_torch.ops import quad_kernel
from nersemble_tpu_torch.ops import sampling as tsm
from nersemble_tpu_torch.ops import sh as tsh
from nersemble_tpu_torch.ops.rendering import exclusive_cumsum

LAYOUT = (6, 12, 4, 1.5)  # dense levels, then 4096-row hashed ones


def _unit_directions(rows, seed):
    d = np.random.default_rng(seed).normal(size=(rows, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encoding_matches_jax(degree):
    """Same closed form in float32: rtol 1e-6."""
    d = _unit_directions(257, degree)
    ours = tsh.sh_encoding(t(d), degree)
    assert ours.shape == (257, tsh.sh_out_dim(degree))
    np.testing.assert_allclose(n(ours), np.asarray(jsh.sh_encoding(jnp.asarray(d), degree)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(n(tsh.unshift_directions(tsh.shift_directions(t(d)))),
                               d, atol=1e-7)


def test_sh_encoding_rejects_degree_five():
    with pytest.raises(ValueError):
        tsh.sh_encoding(torch.zeros(1, 3), 5)


def _levels_both():
    return jhe.HashGridLevels.create(*LAYOUT), the.HashGridLevels.create(*LAYOUT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_encode_matches_jax(dtype):
    """Values: f32 sums in another order (rtol 1e-5 / atol 1e-6 in f32;
    bf16 tables round the same rows, atol 1e-5)."""
    j_lv, t_lv = _levels_both()
    rng = np.random.default_rng(1)
    table = rng.uniform(-1, 1, (j_lv.total_entries, 2)).astype(np.float32)
    x = rng.uniform(0.02, 0.98, (37, 3)).astype(np.float32)
    j_quad = jhe.build_quad_table(jnp.asarray(table), j_lv, jnp.dtype(dtype))
    t_quad = the.build_quad_table(t(table), t_lv, getattr(torch, dtype))
    ref = np.asarray(jhe.hash_encode(j_quad, jnp.asarray(x), j_lv))
    ours = n(the.hash_encode(t_quad, t(x), t_lv))
    assert ours.shape == (37, 6 * 2)
    np.testing.assert_allclose(ours, ref, rtol=1e-5,
                               atol=1e-6 if dtype == "float32" else 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_encode_gradients_match_jax(dtype):
    """Gradients of sum(w * enc) to the canonical table (through the quad
    build's fold) and to x. f32: rtol 1e-4 / atol 1e-6 of the largest; bf16:
    the row gradients round alike, but JAX adds rows in bf16 and the port
    in f32, so the table bound is 2^-7 of the largest (a bf16 ulp or two on
    entries several rows reach); d x is f32 in both, rtol 1e-4."""
    j_lv, t_lv = _levels_both()
    rng = np.random.default_rng(2)
    table = rng.uniform(-1, 1, (j_lv.total_entries, 2)).astype(np.float32)
    x = rng.uniform(0.1, 0.9, (29, 3)).astype(np.float32)
    w = rng.normal(size=(29, 12)).astype(np.float32)

    def j_loss(tab, xx):
        quad = jhe.build_quad_table(tab, j_lv, jnp.dtype(dtype))
        return jnp.sum(jhe.hash_encode(quad, xx, j_lv) * w)

    j_gt, j_gx = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    tab_t = t(table).requires_grad_(True)
    x_t = t(x).requires_grad_(True)
    quad = the.build_quad_table(tab_t, t_lv, getattr(torch, dtype))
    (the.hash_encode(quad, x_t, t_lv) * t(w)).sum().backward()
    j_gt, j_gx = np.asarray(j_gt), np.asarray(j_gx)
    assert np.abs(j_gt).max() > 0 and np.abs(j_gx).max() > 0
    t_atol = (1e-6 if dtype == "float32" else 2.0 ** -7) * np.abs(j_gt).max()
    np.testing.assert_allclose(n(tab_t.grad), j_gt, rtol=1e-4, atol=t_atol)
    np.testing.assert_allclose(n(x_t.grad), j_gx, rtol=1e-4,
                               atol=1e-5 * np.abs(j_gx).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quad_plain_versions_at_two_features_match_xla(dtype):
    """quad_build_plain / quad_fold_plain on [E, 2] tables and their [E, 8]
    gradients (the single grid's rows, narrow rows for B3/B4) against
    ``_quad_fwd_xla`` / ``_quad_bwd_xla``: bit-equal."""
    j_lv, t_lv = _levels_both()
    rng = np.random.default_rng(3)
    table = rng.normal(size=(j_lv.total_entries, 2)).astype(np.float32)
    grad = rng.normal(size=(j_lv.total_entries, 8)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    built = quad_kernel.quad_build_plain(t(table).to(dtype), t_lv)
    ref = np.asarray(jhe._quad_fwd_xla(jnp.asarray(table).astype(jdt), j_lv)
                     .astype(jnp.float32))
    np.testing.assert_array_equal(n(built.float()), ref)
    folded = quad_kernel.quad_fold_plain(t(grad).to(dtype), t_lv)
    ref = np.asarray(jhe._quad_bwd_xla(jnp.asarray(grad).astype(jdt), j_lv)
                     .astype(jnp.float32))
    np.testing.assert_array_equal(n(folded.float()), ref)


def test_cone_march_ts_matches_jax_and_the_recurrence():
    """The closed form against JAX's (rtol 1e-6) and nerfacc's sequential
    ``t += max(t * cone, dt)`` (rtol 1e-5, as tests/test_ops.py)."""
    dt, cone = 0.05, 0.08
    t_near = np.array([0.0, 0.2, 1.5], np.float32)
    k = np.arange(25, dtype=np.float32)[None, :] + np.array([[0.0], [0.3], [0.7]],
                                                            np.float32)
    ours = n(tsm.cone_march_ts(t(t_near), t(k), dt, cone))
    ref = np.asarray(jsm.cone_march_ts(jnp.asarray(t_near), jnp.asarray(k), dt, cone))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
    whole = n(tsm.cone_march_ts(t(t_near), torch.arange(25.0)[None, :], dt, cone))
    for r, tn in enumerate(t_near):
        oracle, tt = [], float(tn)
        for _ in range(25):
            oracle.append(tt)
            tt += max(tt * cone, dt)
        np.testing.assert_allclose(whole[r], oracle, rtol=1e-5, atol=1e-6)


def _rays(count, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(count, 3)).astype(np.float32) * [0.05, 0.3, 0.3] \
        + [1.0, 0.0, 0.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = np.tile(np.array([[-3.0, 0.0, 0.0]], np.float32), (count, 1))
    return o, d, rng


def _grid(rng, levels=1, g=16):
    occ = rng.uniform(size=(levels, g, g, g)) < 0.1
    occ[:, 6:10, 5:11, 5:11] = True
    return occ[0] if levels == 1 else occ


@pytest.mark.parametrize("mode", ["exact", "jittered", "strided", "start_steps"])
def test_march_rays_with_a_cone_angle_matches_jax(mode):
    """Masks equal; t_starts / t_ends rtol 1e-6 under the mask (the same
    closed form in f32)."""
    o, d, rng = _rays(48, 4)
    occ = _grid(rng, levels=2)
    lo, hi = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    jitter = rng.uniform(size=48).astype(np.float32) if mode != "exact" else None
    start = (rng.integers(0, 40, 48).astype(np.float32)
             if mode == "start_steps" else None)
    stride = 2 if mode == "strided" else 1
    binaries = occ if stride == 1 else n(tsm.dilate_binaries(t(occ)))
    kw = dict(near_plane=0.05, far_plane=10.0, cone_angle=0.02,
              occupancy_stride=stride)
    ours, oi = tsm.march_rays(t(o), t(d), t(lo), t(hi), 0.02, 160, 48,
                              binaries=t(binaries),
                              jitter=None if jitter is None else t(jitter),
                              start_steps=None if start is None else t(start), **kw)
    ref, ri = jsm.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                             jnp.asarray(hi), 0.02, 160, 48,
                             binaries=jnp.asarray(binaries),
                             jitter=None if jitter is None else jnp.asarray(jitter),
                             start_steps=None if start is None else jnp.asarray(start),
                             **kw)
    mask = np.asarray(ref.mask)
    assert mask.sum() > 48
    np.testing.assert_array_equal(n(ours.mask), mask)
    np.testing.assert_array_equal(n(oi["n_dropped_per_ray"]),
                                  np.asarray(ri["n_dropped_per_ray"]))
    for a, b in ((ours.t_starts, ref.t_starts), (ours.t_ends, ref.t_ends)):
        np.testing.assert_allclose(n(a)[mask], np.asarray(b)[mask], rtol=1e-6)
    widths = n(ours.t_ends - ours.t_starts)[mask]
    assert widths.max() > 1.5 * widths.min()  # the steps grew


@pytest.mark.parametrize("cone", [0.0, 0.02])
def test_coarse_entry_steps_match_jax(cone):
    """Exact: the same probes on the same dilated grid, equal step indices."""
    o, d, rng = _rays(64, 5)
    occ = n(tsm.dilate_binaries(t(_grid(rng))))
    lo, hi = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    t_near, t_far = tsm.march_range(t(o), t(d), t(lo), t(hi), t(occ), 0.05, 10.0)
    ours = tsm.coarse_entry_steps(t(o), t(d), t_near, t_far, t(occ), t(lo),
                                  t(hi), 0.02, 256, 8, cone)
    ref = jsm.coarse_entry_steps(jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(n(t_near)), jnp.asarray(n(t_far)),
                                 jnp.asarray(occ), jnp.asarray(lo), jnp.asarray(hi),
                                 0.02, 256, 8, cone)
    ref = np.asarray(ref)
    assert (ref == 256).any() and (ref < 256).any()  # hits and misses
    np.testing.assert_array_equal(n(ours), ref)


@pytest.mark.parametrize("cone,levels,given", [(0.0, 1, -1), (0.004, 2, -1),
                                               (0.02, 2, -1), (0.004, 1, 128)])
def test_candidates_to_span_matches_jax(capsys, cone, levels, given):
    """The auto-sized candidate count (and the warning when a given count
    cannot span the box) equal the JAX model's."""
    ours_cfg = flagship_model_config(tiny=True)
    theirs_cfg = __graft_entry__._flagship_model_config(tiny=True)
    for cfg in (ours_cfg, theirs_cfg):
        cfg.cone_angle, cfg.grid_levels = cone, levels
        cfg.sampling.max_candidates_per_ray = given
    ours = NeRSembleModel(ours_cfg, "cpu")
    warned = "WARNING" in capsys.readouterr().out
    theirs = JaxModel(theirs_cfg)
    assert warned == ("WARNING" in capsys.readouterr().out)
    assert warned == (given > 0)
    assert ours.config.sampling.max_candidates_per_ray == \
        theirs.config.sampling.max_candidates_per_ray
    box = np.asarray(ours_cfg.scene_box, np.float32)
    span = float(np.linalg.norm(box[1] - box[0])) * 2.0 ** (levels - 1)
    assert ours._candidates_to_span(span) == theirs._candidates_to_span(span)


def test_early_stop_eps_drops_the_suffix():
    """With eps = 0.3 the kept samples render as without early stop and the
    dropped suffix contributes nothing (tests/test_model.py's check of the
    JAX model): weights within 1e-5 of the eps-0 weights where T >= eps, 0
    elsewhere. Near the init the density is ~1, so 32 steps of 0.05 take T
    to ~0.2."""
    models = []
    for eps in (0.0, 0.3):
        cfg = flagship_model_config(tiny=True)
        cfg.compute_dtype = cfg.table_dtype = "float32"
        cfg.alpha_thre, cfg.early_stop_eps = 0.0, eps
        cfg.render_step_size = 0.05
        cfg.sampling.max_samples_per_ray = 32
        models.append(NeRSembleModel(cfg, "cpu"))
    m0, m1 = models
    params = m0.init_params(torch.Generator().manual_seed(0))
    o, d, rng = _rays(16, 6)
    rays = {"origins": t(o) * (8.0 / 3.0), "directions": t(d),
            "timesteps": torch.from_numpy(rng.integers(0, 8, 16))}
    out0 = m0.render_rays(params, rays, None, {})
    out1 = m1.render_rays(params, rays, None, {})
    w0 = out0["weights"]
    keep = n(1.0 - exclusive_cumsum(w0, dim=-1)) >= 0.3
    assert keep.sum() < keep.size and keep.any()
    np.testing.assert_allclose(n(out1["weights"]), np.where(keep, n(w0), 0.0),
                               atol=1e-5)
    assert (n(out1["accumulation"]) <= n(out0["accumulation"]) + 1e-6).all()
