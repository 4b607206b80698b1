"""ROADMAP C9's CPU rehearsal: the tiny dynamic configuration (the hash
ensemble, the SE(3) deformation field, 8 timesteps) trained for a few
hundred steps in both packages from the same parameters, with the same
batches and the same injected ray jitter, at f32.

The dynamic quality run on the card stays near the background PSNR (C9).
The parity tests stop after five steps; this run goes on long enough to
tell a port fault (the trajectories part early and stay apart) from an
instability of the configuration (both packages go the same way). It
prints the first step at which the losses part beyond the f32 loss
tolerance of the one-step parity test (tests/test_torch_train_step.py TOL),
the first at which a parameter leaf parts by more than two Adam steps (the
most one flipped sign of a cancelling gradient moves it: ROADMAP C10), and
how far the loss curves and the parameters are apart at the end.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dynamic_rehearsal.py -s
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from test_torch_train_step import LRS, R, TOL, _jax_step, _leaves, _port_step, _setup, _trainable
from torch_parity import example_rays

from nersemble_tpu.ops import fused_mlp as jfm
from nersemble_tpu_torch.engine.optimizers import init_adam
from nersemble_tpu_torch.models.nersemble import NeRSembleModel

STEPS = 300
N_TIMESTEPS = 8
LOSS_RTOL = TOL["float32"][0]
# the mean losses of the last WINDOW steps: the curves must end this close
WINDOW = 50
END_RTOL = 0.05


@pytest.fixture(autouse=True)
def interpret_mode():
    jfm.INTERPRET = True
    yield
    jfm.INTERPRET = False


def _batch(step: int) -> dict:
    """A learnable dynamic target: colour a smooth function of the ray's
    direction and timestep, opaque inside a cone around the x axis (the
    tiny scene box's head), depth at its centre."""
    rays = example_rays(R, N_TIMESTEPS, seed=1000 + step)
    d, ts = rays["directions"], rays["timesteps"].astype(np.float32)
    phase = 2.0 * np.pi * ts / N_TIMESTEPS
    rgb = 0.5 + 0.4 * np.stack([np.sin(6 * d[:, 1] + phase),
                                np.cos(6 * d[:, 2] - phase),
                                np.sin(4 * (d[:, 1] + d[:, 2]) + 0.5 * phase)], -1)
    inside = np.hypot(d[:, 1], d[:, 2]) < 0.2
    rays["rgb"] = rgb.astype(np.float32)
    rays["alpha"] = inside.astype(np.float32)
    rays["depth"] = np.full(R, 8.5, np.float32)
    return rays


def _leaf_gap(j_params, ours) -> tuple:
    """(largest |JAX - port| over the parameter entries in units of the
    entry's learning rate, the share of entries past two Adam steps)."""
    theirs = _leaves(j_params)
    mine = {k: v.detach().numpy() for k, v in ours.state_dict().items()}
    groups = {"deformation": LRS["deformation_field"], "embedding": LRS["embeddings"]}
    worst, past, total = 0.0, 0, 0
    for key, value in mine.items():
        lr = next((v for k, v in groups.items() if k in key), LRS["fields"])
        gap = np.abs(value - theirs[key]) / lr
        worst = max(worst, float(gap.max(initial=0.0)))
        past += int((gap > 2.0).sum())
        total += gap.size
    return worst, past / total


def rehearse(steps: int = STEPS) -> dict:
    """Both packages' trajectories over ``steps`` steps; the report."""
    cfg_t, jm, params, _, grid, budget = _setup("float32")
    model = NeRSembleModel(cfg_t, "cpu")
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_opt = optax.scale_by_adam(eps=1e-15).init(j_params)
    ours = _trainable(params)
    state = init_adam(ours)
    j_losses, losses = [], []
    first_loss_step = first_param_step = None
    start = time.perf_counter()
    for step in range(steps):
        batch = _batch(step)
        key = jax.random.PRNGKey(step)
        jitter = np.asarray(jax.random.uniform(key, (R,)))
        j_total, _, _, j_params, j_opt, _ = _jax_step(
            jm, j_params, j_opt, grid, batch, key, budget)
        total, _, _, state, _ = _port_step(model, ours, state, grid, batch,
                                           jitter, budget)
        j_losses.append(j_total)
        losses.append(total)
        if first_loss_step is None and abs(total - j_total) > LOSS_RTOL * abs(j_total):
            first_loss_step = step
        if first_param_step is None or step == steps - 1:
            worst, share = _leaf_gap(j_params, ours)
            if first_param_step is None and worst > 2.0:
                first_param_step = step
    j_losses, losses = np.array(j_losses), np.array(losses)
    return {"steps": steps, "seconds": time.perf_counter() - start,
            "first_loss_step": first_loss_step, "first_param_step": first_param_step,
            "max_loss_rel_gap": float(np.max(np.abs(losses - j_losses) / np.abs(j_losses))),
            "end_loss": float(losses[-WINDOW:].mean()),
            "end_loss_jax": float(j_losses[-WINDOW:].mean()),
            "start_loss": float(losses[:5].mean()),
            "end_param_gap_lrs": worst, "end_params_past_two_steps": share}


@pytest.mark.slow
def test_dynamic_rehearsal_tracks_jax():
    report = rehearse()
    print(f"\nC9 rehearsal: {report}")
    # both packages learn the dynamic target, and their loss curves end
    # together: a port fault in the dynamic path would part them for good
    assert report["end_loss"] < 0.5 * report["start_loss"]
    assert report["end_loss_jax"] < 0.5 * report["start_loss"]
    np.testing.assert_allclose(report["end_loss"], report["end_loss_jax"], rtol=END_RTOL)
    # the five-step parity test's bound holds at least as long as it does
    assert report["first_loss_step"] is None or report["first_loss_step"] >= 5
