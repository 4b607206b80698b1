"""Checkpoints, renders and the train CLI over gloo ranks (CPU tensors).

- A ZeRO-3 checkpoint of 2 ranks (the table and its moments gathered to
  rank 0 in row chunks) opens in the JAX package and in one rank of the
  port, and one step from it on 2 ranks equals that step on one rank; a
  checkpoint of one rank and one the JAX package wrote load into 2 ranks
  (each takes its shard) and save back bit for bit, in the ZeRO-3 and the
  feature-sharded layouts.
- The 2-rank render (each rank its slice of every chunk, the counts
  all-reduced) equals the 1-rank render at the budget None, an overflowing
  budget and "auto" (the JAX render test's atol 5e-5, rtol 1e-4).
"""

import jax
import numpy as np
import optax
import pytest
from test_torch_train_step import _setup
from torch_parallel_parity import assert_close, run, setup, spawn_jobs, spec

import nersemble_tpu.engine.checkpoints as jax_ckpt
from nersemble_tpu_torch.engine.checkpoints import read_flat
from nersemble_tpu_torch.parallel import compare
from nersemble_tpu_torch.utils.cameras import pinhole_frame

# the JAX package's sharded-render bound (tests/test_trainer.py:366)
RENDER_ATOL, RENDER_RTOL = 5e-5, 1e-4
BUDGETS = (None, 256, "auto")


def _batches(cfg, n, seed):
    return compare.synthetic_batches(64, n, cfg.n_timesteps, seed=seed)


def _render_spec(layout, tmp):
    cfg, params, _, grid, _ = setup()
    return {"config": cfg, "layout": layout, "params": params, "grid_occs": grid,
            "frame": pinhole_frame(16, 12, 3), "step": 0, "chunk": 64,
            "budgets": BUDGETS, "out": str(tmp / f"render_{layout}.npz")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-rank and JAX checkpoints, then one set of 2 ranks for every
    job of the file's first two parts."""
    tmp = tmp_path_factory.mktemp("io")
    cfg, params, _, grid, budget = setup()
    one, _ = run(spec(cfg, "replicated", params, grid, _batches(cfg, 2, 8), tmp,
                      "one", budget=budget), 1)
    _, jm, j_params, _, _, _ = _setup("float32")
    jax_ckpt.save_checkpoint(tmp / "jax.ckpt", 4, j_params,
                             optax.scale_by_adam(eps=1e-15).init(j_params), grid)

    def load(layout, path, name, batches=()):
        return ("run_steps", spec(cfg, layout, params, grid, list(batches), tmp,
                                  name, load=str(tmp / path), n_rays=64))

    jobs = [("run_steps", spec(cfg, "zero3", params, grid, _batches(cfg, 3, 9), tmp,
                               "zero3", budget=budget)),
            load("zero3", "zero3.ckpt", "zero3_next", _batches(cfg, 1, 10)),
            load("zero3", "one.ckpt", "one_back"),
            load("zero3", "jax.ckpt", "jax_back_zero3"),
            load("tp", "jax.ckpt", "jax_back_tp"),
            ("render", _render_spec("zero3", tmp)),
            ("render", _render_spec("tp", tmp))]
    results = spawn_jobs(jobs, 2)
    return {"tmp": tmp, "jm": jm, "results": results, "grid": grid}


def test_zero3_checkpoint_opens_in_jax_and_in_one_rank(runs):
    tmp, jm = runs["tmp"], runs["jm"]
    assert runs["results"][0]["layout"] == "zero3"
    flat = read_flat(tmp / "zero3.ckpt")
    j_params = jm.init_params(jax.random.PRNGKey(0))
    step, params, opt, grid, extra = jax_ckpt.load_checkpoint(
        tmp / "zero3.ckpt", j_params, optax.scale_by_adam(eps=1e-15).init(j_params),
        runs["grid"])
    assert step == 2 and int(extra["sample_budget"]) > 0
    np.testing.assert_array_equal(np.asarray(params["field"]["table"]),
                                  flat["params/field/table"])
    np.testing.assert_array_equal(np.asarray(opt.mu["field"]["table"]),
                                  flat["opt_state/mu/field/table"])
    assert flat["params/field/table"].shape == (5120, 16)
    # one rank of the port reads it and writes it back unchanged
    cfg, params_np, _, grid, _ = setup()
    run(spec(cfg, "zero3", params_np, grid, [], tmp, "zero3_back1",
             load=str(tmp / "zero3.ckpt"), n_rays=64), 1)
    back = read_flat(tmp / "zero3_back1.ckpt")
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    # and one more step from it equals that step on 2 ranks
    run(spec(cfg, "zero3", params_np, grid, _batches(cfg, 1, 10), tmp,
             "zero3_next1", load=str(tmp / "zero3.ckpt"), n_rays=64), 1)
    assert_close(read_flat(tmp / "zero3_next.ckpt"), read_flat(tmp / "zero3_next1.ckpt"))


@pytest.mark.parametrize("source,layout", [("one", "zero3"), ("jax", "zero3"),
                                           ("jax", "tp")])
def test_checkpoints_load_into_two_ranks(runs, source, layout):
    """Each rank keeps its shard; gathered back to rank 0, the checkpoint
    is the one it loaded (params, moments, grid, budget), bit for bit."""
    tmp = runs["tmp"]
    original = read_flat(tmp / f"{source}.ckpt")
    back = read_flat(tmp / f"{source}_back{'_' + layout if source == 'jax' else ''}.ckpt")
    for key, value in original.items():
        if key.startswith(("params/", "opt_state/", "grid_occs", "step")):
            np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.mark.parametrize("layout", ["zero3", "tp"])
def test_two_rank_render_matches_one_rank(runs, layout):
    result = runs["results"][5 if layout == "zero3" else 6]
    assert result["layout"] == layout and result["auto_budget"] > 0
    tmp = runs["tmp"]
    many = dict(np.load(tmp / f"render_{layout}.npz"))
    s = _render_spec(layout, tmp)
    s["out"] = str(tmp / f"render_{layout}_one.npz")
    one_result = compare.render(None, s)
    one = dict(np.load(s["out"]))
    assert one_result["auto_budget"] == result["auto_budget"]
    assert one.keys() == many.keys() and len(one) == 4 * len(BUDGETS)
    assert one["None/accumulation"].max() > 0.05  # the frame hits
    for key in one:
        np.testing.assert_allclose(many[key], one[key], atol=RENDER_ATOL,
                                   rtol=RENDER_RTOL, err_msg=key)
