"""Training over several steps: the port's loss trajectory vs the JAX
package's through an occupancy update, and checkpoints in the JAX format
both ways, with bitwise resume within the port (CPU).

Setup and step helpers are test_torch_train_step.py's (tiny flagship config,
contrast-scaled parameters, JAX's fused MLP in interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train_step import (
    R,
    SCHED,
    _jax_step,
    _leaves,
    _port_step,
    _setup,
    _trainable,
)
from torch_parity import example_rays, n, t

from nersemble_tpu.engine import checkpoints as jax_ckpt
from nersemble_tpu.engine.optimizers import fused_adam_update as j_adam
from nersemble_tpu.engine.optimizers import group_of_param as j_groups
from nersemble_tpu.ops import fused_mlp as jfm
from nersemble_tpu_torch.engine.optimizers import init_adam
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.models.nersemble import NeRSembleModel
from nersemble_tpu_torch.ops.occupancy import OccupancyDraws, _sample_occupied_cells
from nersemble_tpu_torch.utils.cameras import synthetic_occupancy


@pytest.fixture(autouse=True)
def interpret_mode():
    jfm.INTERPRET = True
    yield
    jfm.INTERPRET = False


def test_five_steps_with_an_occupancy_update_match_jax():
    """f32; the occupancy update after step 2 gets JAX's draws and must give
    the same binaries (but at cells probed twice). Loss totals agree to rtol
    1e-3: Adam's sign-like
    first steps move parameters whose gradients are below the comparison
    noise differently, which the loss sees only slightly."""
    cfg_t, jm, params, batch, grid, budget = _setup("float32")
    model = NeRSembleModel(cfg_t, "cpu")
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_opt = optax.scale_by_adam(eps=1e-15).init(j_params)
    ours = _trainable(params)
    state = init_adam(ours)
    j_grid, grid_t = jnp.asarray(grid), t(grid)
    j_trace, trace = [], []
    for step in range(5):
        if step == 2:
            key = jax.random.PRNGKey(100)
            pos_rng, time_rng, uni_rng, occ_rng = jax.random.split(key, 4)
            m = grid.shape[0] // 4
            draws = OccupancyDraws(
                cell_jitter=t(jax.random.uniform(pos_rng, (2 * m, 3))),
                timesteps=t(jax.random.randint(time_rng, (2 * m,), 0, 8)).long(),
                uniform_idx=t(jax.random.randint(uni_rng, (m,), 0, grid.shape[0],
                                                 jnp.int32)).long(),
                occupied_u=t(jax.random.uniform(occ_rng, (m,))))
            sched = {k: jnp.float32(v) for k, v in SCHED.items()}
            probed = torch.cat([draws.uniform_idx, _sample_occupied_cells(
                draws.occupied_u, model.binaries(grid_t).reshape(-1))])
            j_grid = jm.occupancy_grid_update(j_params, j_grid, key, sched,
                                              warmup=False)
            grid_t = model.occupancy_grid_update(ours, grid_t, SCHED, False,
                                                 draws=draws)
            # a cell probed more than once keeps its largest candidate here,
            # XLA's last one (ops/occupancy.py)
            once = n(torch.bincount(probed, minlength=grid.shape[0])) <= 1
            ours_b = n(model.binaries(grid_t)).reshape(-1)
            theirs_b = np.asarray(jm.binaries(j_grid)).reshape(-1)
            np.testing.assert_array_equal(ours_b[once], theirs_b[once])
            assert (ours_b[~once] >= theirs_b[~once]).all()
            assert (~once).any() and ours_b.any() and not ours_b.all()
        key = jax.random.PRNGKey(step)
        jitter = np.asarray(jax.random.uniform(key, (R,)))
        j_total, _, _, j_params, j_opt, _ = _jax_step(
            jm, j_params, j_opt, np.asarray(j_grid), batch, key, budget)
        total, _, _, state, _ = _port_step(model, ours, state, n(grid_t), batch,
                                           jitter, budget)
        j_trace.append(j_total)
        trace.append(total)
    assert trace[-1] < trace[0]
    np.testing.assert_allclose(trace, j_trace, rtol=1e-3)


# -- checkpoints -------------------------------------------------------------------

def _batch(step, device="cpu"):
    """Step-indexed batch of the tiny scene (what a ray batcher would give)."""
    rays = example_rays(R, 8, seed=10 + step)
    rng = np.random.default_rng(20 + step)
    out = {k: t(v).to(device) for k, v in rays.items()}
    out["timesteps"] = out["timesteps"].long()
    out["rgb"] = t(rng.uniform(size=(R, 3)).astype(np.float32)).to(device)
    out["alpha"] = t(rng.uniform(size=R).astype(np.float32)).to(device)
    out["depth"] = t(rng.uniform(7.5, 9.5, R).astype(np.float32)).to(device)
    return out


def _trainer(params_np):
    cfg_t, _, _, _, grid, _ = _setup("float32", fraction=0.25)
    cfg_t.sampling.adaptive_budget_interval = 4  # the budget adapts in-run
    cfg_t.occupancy_grid_warmup_steps = 8        # step 16: a sampled update
    return NeRSembleTrainer(cfg_t, n_rays=R, seed=5, device="cpu",
                            params=_trainable(params_np).requires_grad_(False),
                            grid_occs=t(grid))


def _assert_same_state(a: NeRSembleTrainer, b: NeRSembleTrainer):
    for x, y in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu)):
        sx, sy = x.state_dict(), y.state_dict()
        assert sx.keys() == sy.keys()
        for k in sx:
            assert torch.equal(sx[k], sy[k]), k
    assert torch.equal(a.opt_state.count, b.opt_state.count)
    assert torch.equal(a.grid_occs, b.grid_occs)
    assert a._budget == b._budget
    assert a._sample_counts == b._sample_counts
    assert a._budget_drops == b._budget_drops


def test_resume_from_a_checkpoint_is_bitwise(tmp_path):
    _, _, params, _, _, _ = _setup("float32")
    whole = _trainer(params)
    whole.train_batches(_batch, 18)
    assert whole._budget != _trainer(params)._budget  # the budget adapted
    first = _trainer(params)
    first.train_batches(_batch, 10)
    first.save_checkpoint(tmp_path / "step-000000009.ckpt", 9)
    resumed = _trainer(params)
    resumed.load_checkpoint(tmp_path / "step-000000009.ckpt")
    assert resumed.start_step == 10
    resumed.train_batches(_batch, 18)
    _assert_same_state(whole, resumed)


def test_port_checkpoint_loads_in_jax(tmp_path):
    _, jm, params, _, _, _ = _setup("float32")
    trainer = _trainer(params)
    trainer.train_batches(_batch, 3)
    path = tmp_path / "step-000000002.ckpt"
    trainer.save_checkpoint(path, 2)
    template = jm.init_params(jax.random.PRNGKey(1))
    step, j_params, j_opt, j_grid, extra = jax_ckpt.load_checkpoint(
        path, template, optax.scale_by_adam(eps=1e-15).init(template),
        jm.init_grid_occs())
    assert step == 2 and int(j_opt.count) == 3
    assert int(extra["sample_budget"]) == trainer._budget
    np.testing.assert_array_equal(extra["sample_counts"], trainer._sample_counts)
    np.testing.assert_array_equal(j_grid, n(trainer.grid_occs))
    for mine, theirs in ((trainer.params, j_params), (trainer.opt_state.mu, j_opt.mu),
                         (trainer.opt_state.nu, j_opt.nu)):
        leaves = _leaves(theirs)
        state = mine.state_dict()
        assert state.keys() == leaves.keys()
        for k, v in leaves.items():
            np.testing.assert_array_equal(n(state[k]), v, err_msg=k)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    _, jm, params, _, grid, _ = _setup("float32")
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_opt = optax.scale_by_adam(eps=1e-15).init(j_params)
    rng = np.random.default_rng(30)
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)), j_params)
    j_params, j_opt = j_adam(j_params, grads, j_opt,
                             j_groups(jm.param_groups(j_params)),
                             {"fields": np.float32(5e-3),
                              "deformation_field": np.float32(1e-3),
                              "embeddings": np.float32(5e-3)})
    path = tmp_path / "step-000000041.ckpt"
    jax_ckpt.save_checkpoint(path, 41, j_params, j_opt, jnp.asarray(grid) * 0.5,
                             extra={"sample_budget": np.asarray(256),
                                    "sample_counts": np.asarray([300.0, 310.0]),
                                    "budget_drops": np.asarray([0.0, 4.0])})
    trainer = _trainer(params)
    trainer.load_checkpoint(path)
    assert trainer.start_step == 42 and trainer._budget == 256
    assert trainer._sample_counts == [300.0, 310.0]
    assert int(trainer.opt_state.count) == 1
    np.testing.assert_array_equal(n(trainer.grid_occs), grid * 0.5)
    for mine, theirs in ((trainer.params, j_params), (trainer.opt_state.mu, j_opt.mu),
                         (trainer.opt_state.nu, j_opt.nu)):
        state = mine.state_dict()
        for k, v in _leaves(theirs).items():
            np.testing.assert_array_equal(n(state[k]), v, err_msg=k)
    assert all(p.requires_grad for p in trainer.params.parameters())
    total, _ = trainer.run_step(42, _batch(42))
    assert np.isfinite(float(total))
