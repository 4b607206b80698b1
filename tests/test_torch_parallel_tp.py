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

A split that cuts a logical table (``models/field.tp_window``): 3 tables of
2 features over 2 ranks (3 columns each, table 1 cut; each rank pads its
window to 4 columns) and 2 tables of 2 features over 4 ranks (one column
each, padded to 2), held to one rank and to the JAX step over a 2- and a
4-device mesh at the same tolerances; the 2-rank checkpoint opens in the
JAX package and in one rank of the port.
"""

import jax
import numpy as np
import optax
import pytest
from torch_parallel_parity import (
    _setup_cached,
    assert_close,
    assert_step_matches_jax,
    jax_job,
    run,
    setup,
    spawn_jobs,
    spec,
)

import nersemble_tpu.engine.checkpoints as jax_ckpt
from nersemble_tpu_torch.engine.checkpoints import read_flat
from nersemble_tpu_torch.models.field import tp_window
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.parallel import compare
from nersemble_tpu_torch.parallel.mesh import DataMesh


def _spec(tmp_path, name, variant=None):
    cfg, params, _, grid, budget = setup(variant=variant)
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


# (configuration, ranks) whose split cuts a logical table
CUT = [("three_tables", 2), ("two_tables", 4)]


@pytest.fixture(scope="module")
def cut_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_cut")
    out = {"tmp": tmp}
    for variant, n in CUT:
        ref, jax_spec = jax_job("tp", tmp, n=n, variant=variant)
        one = run(_spec(tmp, f"{variant}_one", variant), 1)
        many = spawn_jobs([("run_steps", _spec(tmp, f"{variant}_{n}", variant)),
                           jax_spec], n)
        out[variant] = {"one": one, "many": (many[0], read_flat(tmp / f"{variant}_{n}.ckpt")),
                        "ref": ref, "jax": (many[1], read_flat(jax_spec[1]["out"]))}
    return out


def test_window_pads_a_cut_table_to_whole_tables():
    """Columns [r w, (r+1) w) of tables of f_l features: the tables they
    touch and the zero columns either side."""
    assert tp_window(0, 3, 2) == (slice(0, 2), (0, 1))
    assert tp_window(1, 3, 2) == (slice(1, 3), (1, 0))
    assert [tp_window(r, 1, 2) for r in range(4)] == [
        (slice(0, 1), (0, 1)), (slice(0, 1), (1, 0)), (slice(1, 2), (0, 1)),
        (slice(1, 2), (1, 0))]
    assert tp_window(1, 4, 2) == (slice(2, 4), (0, 0))  # whole tables: no pad
    assert tp_window(2, 5, 4) == (slice(2, 4), (2, 1))  # [10, 15) of [8, 16)


@pytest.mark.parametrize("variant,n", CUT)
def test_cut_split_steps_match_one_rank(cut_runs, variant, n):
    (one, flat1), (many, flat_n) = cut_runs[variant]["one"], cut_runs[variant]["many"]
    assert many["layout"] == "tp" and one["layout"] == "replicated"
    assert flat_n["params/field/table"].shape == flat1["params/field/table"].shape
    assert many["num_budget_dropped"] == one["num_budget_dropped"]
    assert_close(flat_n, flat1)


@pytest.mark.parametrize("variant,n", CUT)
def test_cut_split_step_matches_jax_mesh(cut_runs, variant, n):
    result, flat = cut_runs[variant]["jax"]
    assert result["layout"] == "tp"
    assert_step_matches_jax(cut_runs[variant]["ref"], result, flat)


def test_cut_split_checkpoint_opens_in_jax_and_in_one_rank(cut_runs):
    """The 2-rank checkpoint of 3 tables (table 1 cut): the JAX package
    reads the whole table and its moments, and one rank of the port reads
    it and writes it back bit for bit."""
    variant, n = CUT[0]
    tmp, path = cut_runs["tmp"], cut_runs["tmp"] / f"{variant}_{n}.ckpt"
    flat = read_flat(path)
    assert flat["params/field/table"].shape[1] == 6
    jm = _setup_cached(0.5, variant)[1]
    j_params = jm.init_params(jax.random.PRNGKey(0))
    step, params, opt, _, extra = jax_ckpt.load_checkpoint(
        path, j_params, optax.scale_by_adam(eps=1e-15).init(j_params),
        setup(variant=variant)[3])
    assert step == 2 and int(extra["sample_budget"]) > 0
    for what, leaf in (("params", params), ("opt_state/mu", opt.mu),
                       ("opt_state/nu", opt.nu)):
        np.testing.assert_array_equal(np.asarray(leaf["field"]["table"]),
                                      flat[f"{what}/field/table"], err_msg=what)
    cfg, params_np, _, grid, _ = setup(variant=variant)
    run(spec(cfg, "tp", params_np, grid, [], tmp, "cut_back1", load=str(path),
             n_rays=64), 1)
    back = read_flat(tmp / "cut_back1.ckpt")
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


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
