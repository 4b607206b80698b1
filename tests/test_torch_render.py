"""The render slice: PyTorch port vs the JAX package end to end.

``render_rays(train=False)`` on the tiny flagship config with the same
parameters (JAX init, carried over as numpy). Compute and table dtypes are
float32 here: the JAX blended encode rounds ``rows * code`` to the table
dtype, and bf16 is compared per module in test_torch_ops.py. Parameters are
scaled up from their near-zero init so densities, colours and warps are far
from trivial. Tolerance rtol 1e-4 / atol 1e-5: float32 sums in other orders
through several layers; the pruning thresholds (alpha_thre, the sigma
probe's transmittance) see the same values to within that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import example_rays, n, t, to_numpy_tree

import __graft_entry__
from nersemble_tpu.engine.checkpoints import save_checkpoint
from nersemble_tpu.models.nersemble import NeRSembleModel as JaxModel
from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.engine.checkpoints import load_jax_checkpoint, params_from_numpy
from nersemble_tpu_torch.engine.renderer import Renderer
from nersemble_tpu_torch.models.nersemble import NeRSembleModel
from nersemble_tpu_torch.utils.cameras import (
    CONTRAST_SCALES,
    add_contrast,
    pinhole_frame,
    synthetic_occupancy,
)
from nersemble_tpu_torch.utils.windows import sched_values

TOL = dict(rtol=1e-4, atol=1e-5)
SCHEDS = {"mid": {"window_deform": 2.0, "window_hash": 1.5},
          "end": {"window_deform": 7.0, "window_hash": 8.0}}


def _configs(fraction):
    ours = flagship_model_config(tiny=True)
    theirs = __graft_entry__._flagship_model_config(tiny=True)
    for cfg in (ours, theirs):
        cfg.compute_dtype = cfg.table_dtype = "float32"
        cfg.sampling.global_budget_fraction = fraction
    return ours, theirs


def _scaled_params(jax_model):
    params = to_numpy_tree(jax_model.init_params(jax.random.PRNGKey(0)))
    for key, factor in CONTRAST_SCALES.items():
        *path, leaf = key.split(".")
        node = params
        for part in path:
            node = node[part]
        node[leaf] = node[leaf] * factor
    return params


@pytest.fixture(scope="module")
def grid():
    return synthetic_occupancy(16, 0.05, seed=0)


@pytest.mark.parametrize("fraction", [1.0, 0.125])
@pytest.mark.parametrize("sched", ["mid", "end"])
def test_render_rays_matches_jax(grid, fraction, sched):
    """fraction 1.0 evaluates every slot; 0.125 runs the sigma probe, the
    non-monotone compaction and scatter_rows_back (the budget overflows)."""
    cfg_t, cfg_j = _configs(fraction)
    jm = JaxModel(cfg_j)
    params = _scaled_params(jm)
    tm = NeRSembleModel(cfg_t, "cpu")
    assert tm.config.sampling.max_candidates_per_ray == \
        jm.config.sampling.max_candidates_per_ray
    rays = example_rays(64, 8, seed=1)

    j_out = jm.render_rays(jax.tree_util.tree_map(jnp.asarray, params),
                           {k: jnp.asarray(v) for k, v in rays.items()},
                           jm.binaries(jnp.asarray(grid)),
                           {k: jnp.float32(v) for k, v in SCHEDS[sched].items()},
                           rng=None, train=False)
    t_out = tm.render_rays(params_from_numpy(params, "cpu"),
                           {k: t(v) for k, v in rays.items()},
                           tm.binaries(t(grid)), SCHEDS[sched])

    if fraction < 1.0:
        assert int(t_out["num_budget_dropped"]) > 0
        assert int(t_out["num_budget_dropped"]) == int(j_out["num_budget_dropped"])
    np.testing.assert_array_equal(n(t_out["samples"].mask),
                                  n(j_out["samples"].mask))
    np.testing.assert_array_equal(n(t_out["num_samples_per_ray"]),
                                  n(j_out["num_samples_per_ray"]))
    acc = n(j_out["accumulation"])
    assert acc.max() > 0.01
    for key in ("rgb", "depth", "accumulation", "deformation"):
        np.testing.assert_allclose(n(t_out[key]), n(j_out[key]), **TOL,
                                   err_msg=key)


def test_render_image_packing_matches_unpacked_chunks(grid):
    cfg_t, cfg_j = _configs(1.0)
    params = params_from_numpy(_scaled_params(JaxModel(cfg_j)), "cpu")
    tm = NeRSembleModel(cfg_t, "cpu")
    renderer = Renderer(tm, params, t(grid))
    image = pinhole_frame(10, 14, timestep=3, fov_y_deg=90.0)
    hit = renderer.render_hit_mask(t(image["origins"]), t(image["directions"]))
    assert 0 < int(hit.sum()) < hit.numel()
    step = 80000
    out = renderer.render_image(image, step, chunk=32)

    binaries = tm.binaries(t(grid))
    parts = []
    for lo in range(0, 140, 32):
        rays = {k: t(image[k][lo:lo + 32]) for k in
                ("origins", "directions", "timesteps")}
        o = tm.render_rays(params, rays, binaries, sched_values(cfg_t, step))
        parts.append(torch.cat([o["rgb"], o["depth"], o["accumulation"],
                                o["deformation"]], 1))
    ref = n(torch.cat(parts)).reshape(10, 14, 8)
    np.testing.assert_allclose(out["rgb"], ref[..., 0:3], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out["depth"], ref[..., 3:4], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out["accumulation"], ref[..., 4:5], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(out["deformation"], ref[..., 5:8], rtol=1e-6,
                               atol=1e-6)
    assert out["accumulation"].max() > 0.05


def test_jax_checkpoint_renders_the_same(grid, tmp_path):
    cfg_t, cfg_j = _configs(0.125)
    jm = JaxModel(cfg_j)
    params = _scaled_params(jm)
    path = tmp_path / "step-000000000.ckpt"
    save_checkpoint(path, 0, jax.tree_util.tree_map(jnp.asarray, params), None,
                    jnp.asarray(grid), extra={"sample_budget": 4096})
    loaded, grid_occs, extra = load_jax_checkpoint(path, "cpu")
    assert int(extra["sample_budget"]) == 4096
    np.testing.assert_array_equal(n(grid_occs), grid)

    with np.load(path) as data:
        keys = {k[len("params/"):].replace("/", ".") for k in data.files
                if k.startswith("params/") and "__" not in k}
    assert set(loaded.state_dict()) == keys

    tm = NeRSembleModel(cfg_t, "cpu")
    rays = {k: t(v) for k, v in example_rays(64, 8, seed=2).items()}
    a = tm.render_rays(loaded, rays, tm.binaries(grid_occs), SCHEDS["end"])
    b = tm.render_rays(params_from_numpy(params, "cpu"), rays, tm.binaries(t(grid)),
                       SCHEDS["end"])
    for key in ("rgb", "depth", "accumulation", "deformation"):
        assert torch.equal(a[key], b[key]), key


def test_state_dict_keys_follow_the_jax_tree():
    model = NeRSembleModel(flagship_model_config(tiny=True), "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    jm = JaxModel(__graft_entry__._flagship_model_config(tiny=True))
    shapes = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
              tuple(leaf.shape) for path, leaf in
              jax.tree_util.tree_leaves_with_path(jm.init_params(jax.random.PRNGKey(0)))}
    assert {k: tuple(v.shape) for k, v in params.state_dict().items()} == shapes


def test_add_contrast_scales_like_the_parity_params():
    """``add_contrast`` (chip_smoke.py's scene) scales the port's params as
    ``_scaled_params`` scales the JAX tree, and every key it names exists."""
    cfg_t, cfg_j = _configs(1.0)
    jm = JaxModel(cfg_j)
    raw = params_from_numpy(to_numpy_tree(jm.init_params(jax.random.PRNGKey(0))),
                           "cpu")
    assert set(CONTRAST_SCALES) <= set(raw.state_dict())
    ours = add_contrast(raw).state_dict()
    theirs = params_from_numpy(_scaled_params(jm), "cpu").state_dict()
    for key in theirs:
        assert torch.equal(ours[key], theirs[key]), key


def test_unfused_mlp_option_is_rejected(grid):
    """``use_fused_mlp=False`` was refused; it now runs the unfused chain
    (``apply_mlp``, one matmul per layer) as the JAX package does: both
    packages render the JAX-initialised tiny model with the flag alike."""
    cfg_t, cfg_j = _configs(1.0)
    cfg_t.use_fused_mlp = cfg_j.use_fused_mlp = False
    jm = JaxModel(cfg_j)
    params = _scaled_params(jm)
    tm = NeRSembleModel(cfg_t, "cpu")
    rays = example_rays(64, 8, seed=3)
    j_out = jm.render_rays(jax.tree_util.tree_map(jnp.asarray, params),
                           {k: jnp.asarray(v) for k, v in rays.items()},
                           jm.binaries(jnp.asarray(grid)),
                           {k: jnp.float32(v) for k, v in SCHEDS["end"].items()},
                           rng=None, train=False)
    t_out = tm.render_rays(params_from_numpy(params, "cpu"),
                           {k: t(v) for k, v in rays.items()},
                           tm.binaries(t(grid)), SCHEDS["end"])
    assert n(j_out["accumulation"]).max() > 0.01
    for key in ("rgb", "depth", "accumulation", "deformation"):
        np.testing.assert_allclose(n(t_out[key]), n(j_out[key]), **TOL,
                                   err_msg=key)
