"""Ray data parallelism: the port's training step over 2 and 4 gloo ranks
(CPU tensors) equals the step on one rank and the JAX step over a 2-device
mesh (the counterpart of tests/test_trainer.py's
test_multichip_sharded_step_matches_single), with the budget overflowing:
the compaction keeps exactly the one-rank samples.

Tolerances: tests/torch_parallel_parity.py (atol 5e-5, rtol 1e-3 against
one rank, f32 table and MLPs; test_torch_train_step's f32 bounds against
JAX). The kept masks and the budget-dropped counts are compared exactly.
"""

import numpy as np
import pytest
from torch_parallel_parity import (
    SCHED,
    assert_close,
    assert_step_matches_jax,
    jax_job,
    run,
    setup,
    spawn_jobs,
    spec,
)

from nersemble_tpu_torch.engine.checkpoints import read_flat
from nersemble_tpu_torch.parallel import compare


def _steps_spec(tmp_path, name):
    """Three steps (occupancy update at step 0, the adaptive budget, the
    schedules) with the table replicated and its gradient all-reduced;
    dist_loss_max_rays below the batch, so that the distortion loss counts
    the global ray index."""
    cfg, params, _, grid, budget = setup()
    cfg.dist_loss_max_rays = 40
    batches = compare.synthetic_batches(64, 3, cfg.n_timesteps, seed=5)
    return spec(cfg, "replicated", params, grid, batches, tmp_path, name,
                budget=budget)


def _mask_spec(train):
    cfg, params, batch, grid, _ = setup()
    rng = np.random.default_rng(2)
    return {"config": cfg, "params": params, "grid_occs": grid,
            "batches": [batch], "jitters": [rng.uniform(size=64).astype(np.float32)],
            "sched": SCHED, "train": train, "budget": 256}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One rank here; 2 ranks (steps, the JAX step's, both kept masks) and
    4 ranks (steps) spawned once each."""
    tmp = tmp_path_factory.mktemp("dp")
    ref, jax_spec = jax_job("replicated", tmp)
    one = run(_steps_spec(tmp, "one"), 1)
    two = spawn_jobs([("run_steps", _steps_spec(tmp, "two")), jax_spec,
                      ("kept_mask", _mask_spec(True)),
                      ("kept_mask", _mask_spec(False))], 2)
    four = run(_steps_spec(tmp, "four"), 4)
    return {"one": one, "ref": ref,
            2: (two[0], read_flat(tmp / "two.ckpt")),
            "jax": (two[1], read_flat(jax_spec[1]["out"])),
            "kept": {True: two[2], False: two[3]}, 4: four}


@pytest.mark.parametrize("n", [2, 4])
def test_data_parallel_steps_match_one_rank(runs, n):
    (one, flat1), (many, flat_n) = runs["one"], runs[n]
    assert many["layout"] == "replicated"
    assert many["num_budget_dropped"] == one["num_budget_dropped"]
    assert one["num_budget_dropped"][0] > 0
    assert many["num_samples"] == one["num_samples"]
    np.testing.assert_allclose(many["loss"], one["loss"], rtol=1e-5)
    assert_close(flat_n, flat1)


def test_data_parallel_step_matches_jax_mesh(runs):
    assert_step_matches_jax(runs["ref"], *runs["jax"])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_overflowing_budget_keeps_the_one_rank_mask(runs, train):
    """The staircase compaction of the training forward (per-ray counts
    all-gathered) and the sorted compaction of the eval forward after the
    sigma probe (masks all-gathered) keep, per ray, exactly the samples one
    rank keeps."""
    one = compare.kept_mask(None, _mask_spec(train))
    assert one["dropped"] > 0
    assert runs["kept"][train] == one
