"""PyTorch port vs the JAX package: sampler, compaction, occupancy, compositing.

Sample slots past a ray's valid count hold whatever candidates top_k put
there (its order among the invalid "big" keys differs between frameworks),
so sample arrays are compared under the mask. Integer and selection results
are compared exactly; float32 arithmetic with rtol 1e-6 / atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import example_rays, n, t

from nersemble_tpu.ops import occupancy as jocc
from nersemble_tpu.ops import rendering as jr
from nersemble_tpu.ops import sampling as js
from nersemble_tpu_torch.ops import occupancy as tocc
from nersemble_tpu_torch.ops import rendering as tr
from nersemble_tpu_torch.ops import sampling as ts
from nersemble_tpu_torch.utils.cameras import synthetic_occupancy

BOX = np.array([[-2.5, -2.0, -2.5], [2.5, 3.0, 2.0]], np.float32)
F32 = dict(rtol=1e-6, atol=1e-6)


def _grid(g=16, fill=0.05, seed=0):
    return synthetic_occupancy(g, fill, seed).reshape(g, g, g) > 0.5


@pytest.mark.parametrize("stride", [1, 4])
def test_march_rays(stride):
    grid = _grid()
    rays = example_rays(96, 8, seed=1)
    # a few rays that miss the box entirely
    rays["directions"][:8] = np.array([0.0, 1.0, 0.0], np.float32)
    grid_j = js.dilate_binaries(jnp.asarray(grid)) if stride > 1 else jnp.asarray(grid)
    grid_t = ts.dilate_binaries(t(grid)) if stride > 1 else t(grid)
    args = (0.011, 768, 32)
    js_s, js_info = js.march_rays(rays["origins"], rays["directions"], BOX[0],
                                  BOX[1], *args, binaries=grid_j,
                                  near_plane=0.2, far_plane=1e3,
                                  occupancy_stride=stride)
    ts_s, ts_info = ts.march_rays(t(rays["origins"]), t(rays["directions"]),
                                  t(BOX[0]), t(BOX[1]), *args, binaries=grid_t,
                                  near_plane=0.2, far_plane=1e3,
                                  occupancy_stride=stride)
    mask = n(js_s.mask)
    assert mask.any() and not mask.all()
    np.testing.assert_array_equal(n(ts_s.mask), mask)
    for a, b in ((ts_s.t_starts, js_s.t_starts), (ts_s.t_ends, js_s.t_ends)):
        np.testing.assert_allclose(n(a)[mask], n(b)[mask], **F32)
    for key in ("n_samples_per_ray", "n_dropped_per_ray"):
        np.testing.assert_array_equal(n(ts_info[key]), n(js_info[key]))
    for key in ("t_near", "t_far"):
        np.testing.assert_allclose(n(ts_info[key]), n(js_info[key]), **F32)


@pytest.mark.parametrize("cascade", [False, True])
def test_dilate_binaries_and_lookup(cascade):
    grid = _grid(12, 0.03, seed=2)
    if cascade:
        grid = np.stack([grid, _grid(12, 0.03, seed=3)])
    np.testing.assert_array_equal(n(ts.dilate_binaries(t(grid))),
                                  n(js.dilate_binaries(jnp.asarray(grid))))
    pos = np.random.default_rng(4).uniform(-6, 6, size=(500, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        n(ts.occupancy_lookup(t(grid), t(pos), t(BOX[0]), t(BOX[1]))),
        n(js.occupancy_lookup(jnp.asarray(grid), pos, BOX[0], BOX[1])))


def _monotone_mask(R=50, S=16, seed=5):
    fill = np.random.default_rng(seed).integers(0, S + 1, R)
    return np.arange(S)[None, :] < fill[:, None]


@pytest.mark.parametrize("budget", [128, 384, 800])
def test_compact_samples_monotone(budget):
    mask = _monotone_mask()
    sel_t, kept_t = ts.compact_samples_monotone(t(mask), budget)
    sel_j, kept_j = js.compact_samples_monotone(jnp.asarray(mask), budget)
    np.testing.assert_array_equal(n(sel_t), n(sel_j))
    np.testing.assert_array_equal(n(kept_t), n(kept_j))
    assert len(set(n(sel_t).tolist())) == budget


@pytest.mark.parametrize("budget", [128, 800])
def test_compact_samples(budget):
    mask = np.random.default_rng(6).uniform(size=(50, 16)) < 0.4
    sel_t, kept_t = ts.compact_samples(t(mask), budget)
    sel_j, _, _, kept_j = js.compact_samples(jnp.asarray(mask), budget)
    np.testing.assert_array_equal(n(sel_t), n(sel_j))
    np.testing.assert_array_equal(n(kept_t), n(kept_j))


def test_scatter_rows_back():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    sel = rng.permutation(300)[:64]
    np.testing.assert_array_equal(
        n(ts.scatter_rows_back(t(x), t(sel), 300)),
        n(js.scatter_rows_back(jnp.asarray(x), jnp.asarray(sel), 300)))


@pytest.mark.parametrize("fill", [0.0, 0.002, 0.05])
def test_occupied_world_aabb(fill):
    rng = np.random.default_rng(8)
    grid = rng.uniform(size=(16, 16, 16)) < fill
    lo_t, hi_t, any_t = ts.occupied_world_aabb(t(grid), t(BOX[0]), t(BOX[1]))
    lo_j, hi_j, any_j = js.occupied_world_aabb(jnp.asarray(grid), BOX[0], BOX[1])
    assert any_t == bool(any_j)
    if any_t:
        np.testing.assert_allclose(n(lo_t), n(lo_j), **F32)
        np.testing.assert_allclose(n(hi_t), n(hi_j), **F32)


def test_ray_aabb_intersect_and_march_range():
    rays = example_rays(64, 8, seed=9)
    rays["directions"][:4] = np.array([0.0, 0.0, 1.0], np.float32)
    ours = ts.march_range(t(rays["origins"]), t(rays["directions"]),
                          t(BOX[0]), t(BOX[1]), None, 0.2, 1e3)
    theirs = js.march_range(rays["origins"], rays["directions"], BOX[0],
                            BOX[1], None, 0.2, 1e3)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(n(a), n(b), **F32)


def test_occupancy_binaries():
    occs = np.random.default_rng(10).exponential(0.01, size=4096).astype(np.float32)
    frustum = np.random.default_rng(11).uniform(size=(16, 16, 16)) < 0.7
    for f in (None, frustum):
        ours = tocc.occupancy_binaries(t(occs), 0.01, None if f is None else t(f))
        theirs = jocc.occupancy_binaries(jnp.asarray(occs), 0.01,
                                         None if f is None else jnp.asarray(f))
        np.testing.assert_array_equal(n(ours), n(theirs))


def test_render_weights_and_composites():
    rng = np.random.default_rng(12)
    R, S = 40, 24
    sigmas = rng.exponential(2.0, size=(R, S)).astype(np.float32)
    t0 = np.sort(rng.uniform(1, 5, size=(R, S)).astype(np.float32), axis=1)
    t1 = t0 + 0.011
    mask = _monotone_mask(R, S, seed=13)
    rgbs = rng.uniform(size=(R, S, 3)).astype(np.float32)
    bg = np.ones(3, np.float32)
    w_t, tr_t = tr.render_weights(t(sigmas), t(t0), t(t1), t(mask))
    w_j, tr_j = jr.render_weights(sigmas, t0, t1, mask)
    np.testing.assert_allclose(n(w_t), n(w_j), **F32)
    np.testing.assert_allclose(n(tr_t), n(tr_j), **F32)
    pairs = [
        (tr.render_rgb(w_t, t(rgbs), t(bg)), jr.render_rgb(w_j, rgbs, bg)),
        (tr.render_accumulation(w_t), jr.render_accumulation(w_j)),
        (tr.render_depth_expected(w_t, t(t0), t(t1)),
         jr.render_depth_expected(w_j, t0, t1)),
        (tr.render_expected_value(w_t, t(rgbs)),
         jr.render_expected_value(w_j, rgbs)),
        (tr.exclusive_cumsum(t(sigmas)), jr.exclusive_cumsum(sigmas)),
    ]
    for ours, theirs in pairs:
        np.testing.assert_allclose(n(ours), n(theirs), rtol=1e-5, atol=1e-5)
