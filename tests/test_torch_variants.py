"""The model's other configurations: the port vs the JAX package, end to end
(CPU).

Six configurations on the tiny flagship config of both packages:
- the single-grid field (``use_hash_ensemble=False``) with the deformation
  field, and without it (no time embedding at all);
- the ensemble without the deformation field;
- a cone angle of 0.004 (nerfstudio's Instant-NGP default) on a two-level
  occupancy cascade, whose eval march takes the two-phase prefilter;
- ``early_stop_eps=1e-4``;
- SH degree 4 and the appearance embedding (head input 16 + 15 + 32).

Per configuration: ``render_rays(train=False)`` (test_torch_render.py's
bounds: float32, contrast-scaled JAX parameters carried over as numpy, masks
equal, outputs rtol 1e-4 / atol 1e-5), one train step's losses and every
gradient leaf (test_torch_train_step.py's float32 bounds, JAX's jitter draw
passed in, its fused MLP in interpret mode), one occupancy update with
JAX's draws (binaries equal at cells probed once), and checkpoints of the
single-grid and SH + appearance configurations both ways.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import example_rays, n, t, to_numpy_tree

import __graft_entry__
from chip_smoke import TINY_VARIANTS as VARIANTS
from nersemble_tpu.engine import checkpoints as jax_ckpt
from nersemble_tpu.engine.optimizers import fused_adam_update as j_adam
from nersemble_tpu.engine.optimizers import group_of_param as j_groups
from nersemble_tpu.models.nersemble import NeRSembleModel as JaxModel
from nersemble_tpu.ops import fused_mlp as jfm
from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.engine.checkpoints import (
    load_jax_checkpoint,
    params_from_numpy,
    save_checkpoint,
)
from nersemble_tpu_torch.engine.optimizers import (
    fused_adam_update,
    group_of_param,
    init_adam,
)
from nersemble_tpu_torch.models.nersemble import NeRSembleModel
from nersemble_tpu_torch.ops.occupancy import OccupancyDraws, _sample_occupied_cells
from nersemble_tpu_torch.utils.cameras import CONTRAST_SCALES, synthetic_occupancy

R = 64
N_IMAGES = 5  # the sh_appearance variant's num_images
SCHED = {"window_deform": 2.5, "window_hash": 5.5, "eps_depth": 0.3}
LRS = {"fields": 5e-3, "deformation_field": 1e-3, "embeddings": 5e-3}
RENDER_TOL = dict(rtol=1e-4, atol=1e-5)       # test_torch_render.py
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3, 1e-4  # test_torch_train_step.py f32


@pytest.fixture(autouse=True)
def interpret_mode():
    jfm.INTERPRET = True
    yield
    jfm.INTERPRET = False


def _configs(name, fraction):
    ours = flagship_model_config(tiny=True)
    theirs = __graft_entry__._flagship_model_config(tiny=True)
    for cfg in (ours, theirs):
        cfg.compute_dtype = cfg.table_dtype = "float32"
        cfg.sampling.global_budget_fraction = fraction
        for edit in VARIANTS[name]:
            edit(cfg)
    return ours, theirs


def _params(jm):
    params = to_numpy_tree(jm.init_params(jax.random.PRNGKey(0)))
    for key, factor in CONTRAST_SCALES.items():
        *path, leaf = key.split(".")
        node = params
        for part in path:
            node = node.get(part) if isinstance(node, dict) else None
        if node is not None and leaf in node:
            node[leaf] = node[leaf] * factor
    return params


def _grid(cfg, fill):
    return np.concatenate([synthetic_occupancy(16, fill, seed=lvl)
                           for lvl in range(cfg.grid_levels)])


def _rays(seed):
    rays = example_rays(R, 8, seed=seed)
    rays["camera_indices"] = np.random.default_rng(seed).integers(
        0, N_IMAGES, R).astype(np.int32)
    return rays


def _port_rays(rays):
    out = {k: t(v) for k, v in rays.items()}
    for k in ("timesteps", "camera_indices"):
        out[k] = out[k].long()
    return out


@pytest.mark.parametrize("fraction", [1.0, 0.125])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_render_rays_matches_jax(name, fraction):
    cfg_t, cfg_j = _configs(name, fraction)
    jm = JaxModel(cfg_j)
    tm = NeRSembleModel(cfg_t, "cpu")
    assert tm.config.sampling.max_candidates_per_ray == \
        jm.config.sampling.max_candidates_per_ray
    params = _params(jm)
    grid = _grid(cfg_t, 0.05)
    rays = _rays(1)
    j_out = jm.render_rays(jax.tree_util.tree_map(jnp.asarray, params),
                           {k: jnp.asarray(v) for k, v in rays.items()},
                           jm.binaries(jnp.asarray(grid)),
                           {k: jnp.float32(v) for k, v in SCHED.items()},
                           rng=None, train=False)
    t_out = tm.render_rays(params_from_numpy(params, "cpu"), _port_rays(rays),
                           tm.binaries(t(grid)), SCHED)
    np.testing.assert_array_equal(n(t_out["samples"].mask),
                                  n(j_out["samples"].mask))
    assert int(t_out["num_budget_dropped"]) == int(j_out["num_budget_dropped"])
    assert float(n(j_out["accumulation"]).max()) > 0.01
    keys = ["rgb", "depth", "accumulation"]
    assert ("deformation" in t_out) == cfg_t.use_deformation_field
    if cfg_t.use_deformation_field:
        keys.append("deformation")
    for key in keys:
        np.testing.assert_allclose(n(t_out[key]), n(j_out[key]), **RENDER_TOL,
                                   err_msg=key)


_JAX_STEPS = {}


def _jax_step(name, jm, params, opt_state, grid, batch, key, budget):
    """One jitted JAX training step (value_and_grad + Adam), compiled once
    per configuration."""
    if name not in _JAX_STEPS:
        key_to_group = j_groups(jm.param_groups(params))
        sched = {k: jnp.float32(v) for k, v in SCHED.items()}

        def step(params, opt_state, grid, jbatch, key):
            def loss_fn(p):
                out = jm.render_rays(p, jbatch, jm.binaries(grid), sched,
                                     rng=key, train=True, budget=budget)
                losses = jm.compute_losses(out, jbatch, sched, train=True)
                return sum(losses.values()), losses

            (total, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            new_params, new_state = j_adam(
                params, grads, opt_state, key_to_group,
                {k: np.float32(v) for k, v in LRS.items()})
            return total, losses, grads, new_params, new_state

        _JAX_STEPS[name] = jax.jit(step)
    total, losses, grads, new_params, new_state = _JAX_STEPS[name](
        params, opt_state, jnp.asarray(grid),
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return float(total), {k: float(v) for k, v in losses.items()}, grads, \
        new_params, new_state


def _port_step(model, params, state, grid, batch, jitter, budget):
    """What NeRSembleTrainer.train_step does, keeping the gradients (zeros
    for a leaf the loss does not reach)."""
    tbatch = _port_rays(batch)
    out = model.render_rays(params, tbatch, model.binaries(t(grid)), SCHED,
                            train=True, budget=budget, jitter=t(jitter))
    losses = model.compute_losses(out, tbatch, SCHED, train=True)
    total = sum(losses.values())
    total.backward()
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for k, p in params.named_parameters()}
    state = fused_adam_update(params, state,
                              group_of_param(model.param_groups(params)), LRS)
    for p in params.parameters():
        p.grad = None
    return float(total.detach()), \
        {k: float(v.detach()) for k, v in losses.items()}, grads, state


def _leaves(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf) for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(seed):
    batch = _rays(seed)
    rng = np.random.default_rng(seed + 2)
    batch["rgb"] = rng.uniform(size=(R, 3)).astype(np.float32)
    batch["alpha"] = rng.uniform(size=R).astype(np.float32)
    batch["depth"] = rng.uniform(7.5, 9.5, R).astype(np.float32)
    return batch


def _trainable(params_np):
    p = params_from_numpy(params_np, "cpu")
    for q in p.parameters():
        q.requires_grad_(True)
    return p


@pytest.mark.parametrize("name", list(VARIANTS))
def test_train_step_and_occupancy_update_match_jax(name):
    """Losses rtol 1e-4, every gradient leaf rtol 1e-3 / atol 1e-4 of its
    largest (a leaf the loss does not reach is zero in both); then one
    occupancy update with JAX's draws: binaries equal wherever a cell was
    probed once (a cell probed twice keeps its largest candidate in the
    port, XLA's last; test_torch_train_resume.py)."""
    cfg_t, cfg_j = _configs(name, 0.5)
    jm = JaxModel(cfg_j)
    params = _params(jm)
    grid = _grid(cfg_t, 0.3)
    batch = _batch(1)
    budget = -(-int(R * 16 * 0.5) // 128) * 128
    key = jax.random.PRNGKey(7)
    jitter = np.asarray(jax.random.uniform(key, (R,)))  # render_rays' own draw
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_opt = optax.scale_by_adam(eps=1e-15).init(j_params)
    j_total, j_losses, j_grads, j_new, _ = _jax_step(
        name, jm, j_params, j_opt, grid, batch, key, budget)

    model = NeRSembleModel(cfg_t, "cpu")
    ours = _trainable(params)
    total, losses, grads, _ = _port_step(model, ours, init_adam(ours), grid,
                                         batch, jitter, budget)
    assert losses.keys() == j_losses.keys() and len(losses) == 6
    for k in losses:
        assert losses[k] == pytest.approx(j_losses[k], rel=LOSS_RTOL, abs=1e-9), k
    assert total == pytest.approx(j_total, rel=LOSS_RTOL)
    j_g = _leaves(j_grads)
    assert set(grads) == set(j_g)
    if cfg_t.use_appearance_embedding:
        assert np.abs(j_g["field.appearance_embedding"]).max() > 0
    for k, ref in j_g.items():
        scale = np.abs(ref).max()
        np.testing.assert_allclose(n(grads[k]), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=f"grad {k}")

    # one sampled occupancy update on the stepped parameters
    occ_key = jax.random.PRNGKey(100)
    pos_rng, time_rng, uni_rng, occ_rng = jax.random.split(occ_key, 4)
    m = grid.shape[0] // 4
    draws = OccupancyDraws(
        cell_jitter=t(jax.random.uniform(pos_rng, (2 * m, 3))),
        timesteps=t(jax.random.randint(time_rng, (2 * m,), 0, 8)).long(),
        uniform_idx=t(jax.random.randint(uni_rng, (m,), 0, grid.shape[0],
                                         jnp.int32)).long(),
        occupied_u=t(jax.random.uniform(occ_rng, (m,))))
    grid_t = t(grid)
    probed = torch.cat([draws.uniform_idx, _sample_occupied_cells(
        draws.occupied_u, model.binaries(grid_t).reshape(-1))])
    j_grid = jm.occupancy_grid_update(j_new, jnp.asarray(grid), occ_key,
                                      {k: jnp.float32(v) for k, v in SCHED.items()},
                                      warmup=False)
    grid_t = model.occupancy_grid_update(ours, grid_t, SCHED, False, draws=draws)
    once = n(torch.bincount(probed, minlength=grid.shape[0])) <= 1
    ours_b = n(model.binaries(grid_t)).reshape(-1)
    theirs_b = np.asarray(jm.binaries(j_grid)).reshape(-1)
    np.testing.assert_array_equal(ours_b[once], theirs_b[once])
    np.testing.assert_allclose(n(grid_t)[once], np.asarray(j_grid)[once],
                               rtol=1e-3, atol=1e-6)
    assert ours_b.any() and not ours_b.all()


@pytest.mark.parametrize("name", ["single_grid", "sh_appearance"])
def test_checkpoints_cross_both_ways(name, tmp_path):
    """A JAX checkpoint loads into the port with the JAX tree's keys and
    shapes and renders bit-equal to the same parameters carried over as
    numpy; a port checkpoint loads back into JAX with every leaf equal."""
    cfg_t, cfg_j = _configs(name, 0.125)
    jm = JaxModel(cfg_j)
    params = _params(jm)
    grid = _grid(cfg_t, 0.05)
    path = tmp_path / "step-000000003.ckpt"
    jax_ckpt.save_checkpoint(path, 3, jax.tree_util.tree_map(jnp.asarray, params),
                             None, jnp.asarray(grid))
    loaded, grid_occs, _ = load_jax_checkpoint(path, "cpu")
    shapes = {k: tuple(v.shape) for k, v in _leaves(params).items()}
    assert {k: tuple(v.shape) for k, v in loaded.state_dict().items()} == shapes
    if name == "single_grid":
        assert shapes["field.table"][1] == 2
    else:
        assert shapes["field.appearance_embedding"] == (N_IMAGES, 32)
        assert shapes["field.mlp_head.layers.0.w"][0] == 16 + 15 + 32

    tm = NeRSembleModel(cfg_t, "cpu")
    rays = _port_rays(_rays(2))
    a = tm.render_rays(loaded, rays, tm.binaries(grid_occs), SCHED)
    b = tm.render_rays(params_from_numpy(params, "cpu"), rays, tm.binaries(t(grid)),
                       SCHED)
    for key in ("rgb", "depth", "accumulation"):
        assert torch.equal(a[key], b[key]), key

    ours = _trainable(params)
    port_path = tmp_path / "step-000000004.ckpt"
    save_checkpoint(port_path, 4, ours, init_adam(ours), t(grid))
    template = jm.init_params(jax.random.PRNGKey(1))
    step, j_params, _, j_grid, _ = jax_ckpt.load_checkpoint(
        port_path, template, optax.scale_by_adam(eps=1e-15).init(template),
        jm.init_grid_occs())
    assert step == 4
    np.testing.assert_array_equal(np.asarray(j_grid), grid)
    back = _leaves(j_params)
    assert back.keys() == shapes.keys()
    for k, v in _leaves(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_port_init_matches_the_jax_tree():
    """``init_params`` of every configuration has the JAX tree's keys and
    shapes (the appearance embedding included)."""
    for name in VARIANTS:
        cfg_t, cfg_j = _configs(name, 1.0)
        ours = NeRSembleModel(cfg_t, "cpu").init_params(torch.Generator().manual_seed(0))
        theirs = _leaves(JaxModel(copy.deepcopy(cfg_j)).init_params(jax.random.PRNGKey(0)))
        assert {k: tuple(v.shape) for k, v in ours.state_dict().items()} == \
            {k: v.shape for k, v in theirs.items()}, name
