"""The training slice as a whole: one step of the port vs the JAX package.

``flagship_model_config(tiny=True)`` with contrast-scaled parameters (the
JAX init carried over as numpy and scaled like ``utils/cameras.add_contrast``,
so the table, the time codes and the warp shape the output), a 30%-fill
grid, a compaction budget below R*S, all six losses on, JAX's jitter draw
passed in and its fused MLP in interpret mode. Compared: the loss dict,
every gradient leaf, and the parameters and Adam moments after the update;
then five steps with an occupancy update in between.

Adam's first step moves a parameter by about lr * sign(grad), so where a
gradient is below the comparison's noise its sign, and the update, may
differ: updates are compared where |grad| exceeds 100x the gradient bound's
atol, and bounded by lr elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import example_rays, n, t, to_numpy_tree

import __graft_entry__
from nersemble_tpu.engine.optimizers import fused_adam_update as j_adam
from nersemble_tpu.engine.optimizers import group_of_param as j_groups
from nersemble_tpu.models.nersemble import NeRSembleModel as JaxModel
from nersemble_tpu.ops import fused_mlp as jfm
from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.engine.checkpoints import params_from_numpy
from nersemble_tpu_torch.engine.optimizers import fused_adam_update, init_adam
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.ops.occupancy import OccupancyDraws
from nersemble_tpu_torch.utils.cameras import CONTRAST_SCALES, synthetic_occupancy

R = 64
SCHED = {"window_deform": 2.5, "window_hash": 5.5, "eps_depth": 0.3}
LRS = {"fields": 5e-3, "deformation_field": 1e-3, "embeddings": 5e-3}
# (loss rtol, gradient rtol, gradient atol as a fraction of the leaf's max).
# float32: the same expressions summed in other orders. bfloat16: both round
# at the same points, but the recomputed bf16 forwards (MLPs, encode) sum in
# other orders and can round an activation to the neighbouring bf16 value.
TOL = {"float32": (1e-4, 1e-3, 1e-4), "bfloat16": (1e-3, 1e-2, 2e-3)}
# bf16 table gradient: JAX adds the hashed levels' rows in bf16, the port in
# f32 (tests/test_torch_train_encode.py bounds that per entry); here an atol
# of 2^-6 of the leaf's max covers it
BF16_TABLE_ATOL = 2.0 ** -6


@pytest.fixture(autouse=True)
def interpret_mode():
    jfm.INTERPRET = True
    yield
    jfm.INTERPRET = False


def _setup(dtype, fraction=0.5):
    cfg_t = flagship_model_config(tiny=True)
    cfg_j = __graft_entry__._flagship_model_config(tiny=True)
    for cfg in (cfg_t, cfg_j):
        cfg.compute_dtype = cfg.table_dtype = dtype
        cfg.sampling.global_budget_fraction = fraction
    jm = JaxModel(cfg_j)
    params = to_numpy_tree(jm.init_params(jax.random.PRNGKey(0)))
    for key, factor in CONTRAST_SCALES.items():
        *path, leaf = key.split(".")
        node = params
        for part in path:
            node = node[part]
        node[leaf] = node[leaf] * factor
    rng = np.random.default_rng(3)
    batch = example_rays(R, 8, seed=1)
    batch["rgb"] = rng.uniform(size=(R, 3)).astype(np.float32)
    batch["alpha"] = rng.uniform(size=R).astype(np.float32)
    batch["depth"] = rng.uniform(7.5, 9.5, R).astype(np.float32)
    grid = synthetic_occupancy(16, 0.3, seed=0)
    budget = -(-int(R * 16 * fraction) // 128) * 128
    return cfg_t, jm, params, batch, grid, budget


_JAX_STEPS = {}


def _jax_step(jm, params, opt_state, grid, batch, key, budget):
    """One jitted JAX training step (value_and_grad + fused_adam_update),
    compiled once per (model, budget)."""
    if (id(jm), budget) not in _JAX_STEPS:
        key_to_group = j_groups(jm.param_groups(params))
        sched = {k: jnp.float32(v) for k, v in SCHED.items()}

        def step(params, opt_state, grid, jbatch, key):
            def loss_fn(p):
                out = jm.render_rays(p, jbatch, jm.binaries(grid), sched,
                                     rng=key, train=True, budget=budget)
                losses = jm.compute_losses(out, jbatch, sched, train=True)
                return sum(losses.values()), (losses, out["num_budget_dropped"])

            (total, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            new_params, new_state = j_adam(
                params, grads, opt_state, key_to_group,
                {k: np.float32(v) for k, v in LRS.items()})
            return total, aux, grads, new_params, new_state

        _JAX_STEPS[(id(jm), budget)] = (jm, jax.jit(step))
    total, (losses, dropped), grads, new_params, new_state = \
        _JAX_STEPS[(id(jm), budget)][1](
            params, opt_state, jnp.asarray(grid),
            {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return float(total), {k: float(v) for k, v in losses.items()}, grads, \
        new_params, new_state, int(dropped)


def _port_step(model, params, state, grid, batch, jitter, budget):
    """What NeRSembleTrainer.train_step does, keeping the gradients."""
    from nersemble_tpu_torch.engine.optimizers import group_of_param
    tbatch = {k: t(v) for k, v in batch.items()}
    tbatch["timesteps"] = tbatch["timesteps"].long()
    out = model.render_rays(params, tbatch, model.binaries(t(grid)), SCHED,
                            train=True, budget=budget, jitter=t(jitter))
    losses = model.compute_losses(out, tbatch, SCHED, train=True)
    total = sum(losses.values())
    total.backward()
    grads = {k: p.grad.clone() for k, p in params.named_parameters()}
    state = fused_adam_update(params, state,
                              group_of_param(model.param_groups(params)), LRS)
    for p in params.parameters():
        p.grad = None
    return float(total.detach()), {k: float(v.detach()) for k, v in losses.items()}, \
        grads, state, int(out["num_budget_dropped"])


def _trainable(params_np, device="cpu"):
    p = params_from_numpy(params_np, device)
    for q in p.parameters():
        q.requires_grad_(True)
    return p


def _leaves(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf) for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(dtype):
    loss_rtol, g_rtol, g_atol = TOL[dtype]
    cfg_t, jm, params, batch, grid, budget = _setup(dtype)
    key = jax.random.PRNGKey(7)
    jitter = np.asarray(jax.random.uniform(key, (R,)))  # render_rays' own draw
    j_opt = optax.scale_by_adam(eps=1e-15).init(params)
    j_total, j_losses, j_grads, j_new, j_state, j_dropped = _jax_step(
        jm, jax.tree_util.tree_map(jnp.asarray, params), j_opt, grid, batch,
        key, budget)

    from nersemble_tpu_torch.models.nersemble import NeRSembleModel
    model = NeRSembleModel(cfg_t, "cpu")
    ours = _trainable(params)
    state = init_adam(ours)
    total, losses, grads, state, dropped = _port_step(
        model, ours, state, grid, batch, jitter, budget)

    assert dropped == j_dropped > 0  # the budget compaction ran and overflowed
    assert losses.keys() == j_losses.keys() and len(losses) == 6
    for k in losses:
        assert losses[k] == pytest.approx(j_losses[k], rel=loss_rtol, abs=1e-9), k
    assert total == pytest.approx(j_total, rel=loss_rtol)

    j_g, j_p, j_mu, j_nu = (_leaves(x) for x in (j_grads, j_new, j_state.mu,
                                                  j_state.nu))
    assert set(grads) == set(j_g)
    new = dict(ours.named_parameters())
    mu, nu = dict(state.mu.named_parameters()), dict(state.nu.named_parameters())
    for k, ref in j_g.items():
        atol = g_atol * np.abs(ref).max()
        if dtype == "bfloat16" and k == "field.table":
            atol = BF16_TABLE_ATOL * np.abs(ref).max()
        assert np.abs(ref).max() > 0, k
        np.testing.assert_allclose(n(grads[k]), ref, rtol=g_rtol, atol=atol,
                                   err_msg=f"grad {k}")
        np.testing.assert_allclose(n(mu[k]), j_mu[k], rtol=g_rtol, atol=0.1 * atol,
                                   err_msg=f"mu {k}")
        np.testing.assert_allclose(n(nu[k]), j_nu[k], rtol=2 * g_rtol,
                                   atol=1e-3 * atol * np.abs(ref).max(),
                                   err_msg=f"nu {k}")
        lr = LRS[{"field": "fields", "deformation": "deformation_field"}.get(
            k.split(".")[0], "embeddings")]
        upd, j_upd = (params_leaf(params, k) - n(new[k])) / lr, \
            (params_leaf(params, k) - j_p[k]) / lr
        sure = np.abs(ref) > 100 * atol
        np.testing.assert_allclose(upd[sure], j_upd[sure], rtol=1e-3, atol=1e-3,
                                   err_msg=f"update {k}")
        assert np.abs(upd).max() <= 1.0 + 1e-3, k


def params_leaf(params, key):
    node = params
    for part in key.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return np.asarray(node)


def test_trainer_train_step_is_the_step():
    """NeRSembleTrainer.train_step (jitter passed in) updates the parameters
    exactly as the step above."""
    cfg_t, jm, params, batch, grid, budget = _setup("float32")
    jitter = np.random.default_rng(4).uniform(size=R).astype(np.float32)
    from nersemble_tpu_torch.models.nersemble import NeRSembleModel
    ours = _trainable(params)
    _port_step(NeRSembleModel(cfg_t, "cpu"), ours, init_adam(ours), grid, batch,
               jitter, budget)
    trainer = NeRSembleTrainer(cfg_t, n_rays=R, device="cpu",
                               params=params_from_numpy(params, "cpu"),
                               grid_occs=t(grid))
    trainer._budget = budget
    tbatch = {k: t(v) for k, v in batch.items()}
    tbatch["timesteps"] = tbatch["timesteps"].long()
    trainer.sched_values = lambda step: SCHED
    trainer.lr_values = lambda step: LRS
    trainer.train_step(0, tbatch, jitter=t(jitter))
    a, b = ours.state_dict(), trainer.params.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
