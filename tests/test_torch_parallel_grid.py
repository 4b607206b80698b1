"""The feature-sharded single grid (``shard_hash_tables`` on the single-grid
field) over gloo ranks (CPU tensors), the layout the JAX trainer takes
whenever the row width divides (nersemble_tpu/engine/trainer.py:86-93):
each of 2 ranks holds one of the [E, 2] table's two feature columns (and
its Adam moments), encodes it over every rank's rows and gets its own rows
back with both features (``models/field.encode_grid``). On the tiny
flagship config edited as ``chip_smoke.TINY_VARIANTS["single_grid"]`` (4
levels of at most 2^10 rows: a smaller grid than the train CLI's
6,184,960 rows):

- the features of 2 ranks equal one rank's bit for bit, for rows split
  over the ranks and for rows every rank holds (the occupancy update's);
- three steps over 2 ranks equal one rank at
  tests/torch_parallel_parity.py's tolerances (atol 5e-5, rtol 1e-3);
- one step equals the JAX step with the table at ``P(None, "data")`` on a
  2-device mesh (``assert_step_matches_jax``);
- the 2-rank checkpoint opens in the JAX package and in one rank of the
  port (read and written back bit for bit);
- the layout choice: the single grid shards at any width that divides and
  prints no refusal; so does the hash ensemble, also where a split cuts a
  logical table.
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
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.parallel import compare
from nersemble_tpu_torch.parallel.mesh import DataMesh

VARIANT = "single_grid"


def _spec(tmp, name, **extra):
    cfg, params, _, grid, budget = setup(variant=VARIANT)
    batches = compare.synthetic_batches(64, 3, cfg.n_timesteps, seed=11)
    return spec(cfg, "tp", params, grid, batches, tmp, name, budget=budget, **extra)


def _features_spec(tmp, name):
    cfg, params, _, _, _ = setup(variant=VARIANT)
    positions = np.random.default_rng(5).uniform(size=(96, 3)).astype(np.float32)
    positions[:8] = 0.5  # rows that share their entries
    return {"config": cfg, "layout": "tp", "params": params, "positions": positions,
            "out": str(tmp / f"{name}.npz")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid")
    ref, jax_spec = jax_job("tp", tmp, variant=VARIANT)
    one = run(_spec(tmp, "one"), 1)
    compare.features(None, _features_spec(tmp, "features_one"))
    two = spawn_jobs([("run_steps", _spec(tmp, "two")), jax_spec,
                      ("features", _features_spec(tmp, "features_two"))], 2)
    return {"tmp": tmp, "one": one, "two": (two[0], read_flat(tmp / "two.ckpt")),
            "ref": ref, "jax": (two[1], read_flat(jax_spec[1]["out"])),
            "features": two[2]}


def test_single_grid_features_over_two_ranks_are_one_ranks_bit_for_bit(runs):
    tmp = runs["tmp"]
    assert runs["features"]["layout"] == "tp"
    one, two = np.load(tmp / "features_one.npz"), np.load(tmp / "features_two.npz")
    for key in ("rows", "replicated"):
        assert two[key].shape == (96, 4 * 2)
        np.testing.assert_array_equal(two[key], one[key], err_msg=key)
    assert np.abs(one["rows"]).max() > 0


def test_single_grid_steps_over_two_ranks_match_one_rank(runs):
    (one, flat1), (two, flat2) = runs["one"], runs["two"]
    assert two["layout"] == "tp" and one["layout"] == "replicated"
    assert flat2["params/field/table"].shape == flat1["params/field/table"].shape
    assert two["num_budget_dropped"] == one["num_budget_dropped"]
    assert_close(flat2, flat1)


def test_single_grid_step_matches_jax_mesh(runs):
    result, flat = runs["jax"]
    assert result["layout"] == "tp"
    assert_step_matches_jax(runs["ref"], result, flat)


def test_single_grid_checkpoint_opens_in_jax_and_in_one_rank(runs):
    tmp = runs["tmp"]
    flat = read_flat(tmp / "two.ckpt")
    jm = _setup_cached(0.5, VARIANT)[1]
    j_params = jm.init_params(jax.random.PRNGKey(0))
    step, params, opt, _, extra = jax_ckpt.load_checkpoint(
        tmp / "two.ckpt", j_params, optax.scale_by_adam(eps=1e-15).init(j_params),
        setup(variant=VARIANT)[3])
    assert step == 2 and int(extra["sample_budget"]) > 0
    for what, leaf in (("params", params), ("opt_state/mu", opt.mu),
                       ("opt_state/nu", opt.nu)):
        np.testing.assert_array_equal(np.asarray(leaf["field"]["table"]),
                                      flat[f"{what}/field/table"], err_msg=what)
    cfg, params_np, _, grid, _ = setup(variant=VARIANT)
    run(spec(cfg, "tp", params_np, grid, [], tmp, "back1", load=str(tmp / "two.ckpt"),
             n_rays=64), 1)
    back = read_flat(tmp / "back1.ckpt")
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


class _Ranks(DataMesh):
    """A mesh of ``n`` ranks for the layout choice alone (no group)."""

    def __init__(self, n):
        super().__init__()
        self.size = n


def _choose(cfg, n, shape):
    trainer = NeRSembleTrainer.__new__(NeRSembleTrainer)
    trainer.mesh, trainer.config = _Ranks(n), cfg

    class _Model:  # takes the table_layout the choice sets
        table_layout = None

    trainer.model = _Model()
    return trainer._choose_layout(compare.LAYOUTS["tp"], shape), trainer.model


def test_single_grid_takes_the_feature_sharded_layout(capsys):
    cfg = setup(variant=VARIANT)[0]
    layout, model = _choose(cfg, 2, (5120, 2))
    assert layout == "tp" and model.table_layout[0] == "cols"
    assert "disabled" not in capsys.readouterr().out
    # a width that does not divide: the JAX trainer's message and fallback
    assert _choose(cfg, 3, (5120, 2))[0] == "replicated"
    assert "row width 2 not divisible by 3 devices" in capsys.readouterr().out


def test_ensemble_refuses_only_a_split_that_cuts_a_logical_table(capsys):
    """8 tables of 2 features: 8 ranks take whole tables, and 16 ranks, one
    feature of a table each, take the feature-sharded layout too and print
    no refusal. The port once kept such a table whole and fell back; each
    rank now pads its columns with zeros to the tables they touch
    (``models/field.tp_window``), so it takes every split the JAX trainer
    takes (the width divides). Only a width that does not divide still
    falls back (test_single_grid_takes_the_feature_sharded_layout)."""
    cfg = setup()[0]
    assert _choose(cfg, 8, (5120, 16))[0] == "tp"
    assert "disabled" not in capsys.readouterr().out
    layout, model = _choose(cfg, 16, (5120, 16))
    assert layout == "tp" and model.table_layout[0] == "cols"
    assert "disabled" not in capsys.readouterr().out
