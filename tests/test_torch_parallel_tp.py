"""The feature-sharded hash table (``shard_hash_tables``) over gloo ranks
(CPU tensors), the counterpart of tests/test_table_sharding.py's
test_table_sharded_training_matches_replicated: each rank holds the [E,
W/n] columns of its logical tables (and their Adam moments), blends them
over every rank's rows (positions and codes all-gathered) and
reduce-scatters the partial features; the occupancy update blends the same
rows on every rank and all-reduces. Equal to one rank and to the JAX step
with the table at ``P(None, "data")`` over a 2-device mesh, at
tests/torch_parallel_parity.py's tolerances (atol 5e-5, rtol 1e-3 against
one rank). A row width that does not divide keeps the table replicated, as
the JAX trainer does.
"""

import pytest
from torch_parallel_parity import (
    assert_close,
    assert_step_matches_jax,
    jax_job,
    run,
    setup,
    spawn_jobs,
    spec,
)

from nersemble_tpu_torch.engine.checkpoints import read_flat
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.parallel import compare
from nersemble_tpu_torch.parallel.mesh import DataMesh


def _spec(tmp_path, name):
    cfg, params, _, grid, budget = setup()
    batches = compare.synthetic_batches(64, 3, cfg.n_timesteps, seed=7)
    return spec(cfg, "tp", params, grid, batches, tmp_path, name, budget=budget)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    ref, jax_spec = jax_job("tp", tmp)
    one = run(_spec(tmp, "one"), 1)
    two = spawn_jobs([("run_steps", _spec(tmp, "two")), jax_spec], 2)
    return {"one": one, 2: (two[0], read_flat(tmp / "two.ckpt")),
            4: run(_spec(tmp, "four"), 4), "ref": ref,
            "jax": (two[1], read_flat(jax_spec[1]["out"]))}


@pytest.mark.parametrize("n", [2, 4])
def test_feature_sharded_steps_match_one_rank(runs, n):
    """8 logical tables of 2 features: whole tables over 2 and 4 ranks."""
    (one, flat1), (many, flat_n) = runs["one"], runs[n]
    assert many["layout"] == "tp"
    assert many["num_budget_dropped"] == one["num_budget_dropped"]
    assert_close(flat_n, flat1)


def test_feature_sharded_step_matches_jax_mesh(runs):
    result, flat = runs["jax"]
    assert result["layout"] == "tp"
    assert_step_matches_jax(runs["ref"], result, flat)


class _ThreeRanks(DataMesh):
    """A mesh of three ranks for the layout choice alone (no group)."""

    def __init__(self):
        super().__init__()
        self.size = 3


def test_feature_sharding_falls_back_when_the_width_does_not_divide(capsys):
    """16 columns over 3 ranks: the JAX trainer's message, then the ZeRO
    layouts' rule (5120 entries do not divide by 3 either: replicated)."""
    trainer = NeRSembleTrainer.__new__(NeRSembleTrainer)
    trainer.mesh, trainer.config, trainer.model = _ThreeRanks(), setup()[0], None
    assert trainer._choose_layout(compare.LAYOUTS["tp"], (5120, 16)) == "replicated"
    assert "shard_hash_tables disabled: row width 16 not divisible by 3 devices" \
        in capsys.readouterr().out
