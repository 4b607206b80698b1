"""The ZeRO layouts of the hash table over gloo ranks (CPU tensors), the
counterparts of tests/test_table_sharding.py's
test_zero3_table_pipeline_matches_replicated and
test_zero_sharded_optimizer_matches_replicated:

- ZeRO-3 (``shard_table_params``): each rank holds an [E/n, W] entry shard
  of the table and of its Adam moments; the forward all-gathers the cast
  shard, the backward reduce-scatters the folded gradient;
- moments-only (``shard_table_optimizer``): the table is replicated, its
  moments are [E/n, W] shards, the gradient is reduce-scattered and the
  updated rows all-gathered.

Each equals one rank and the JAX step over a 2-device mesh in the same
shardings. Tolerances: tests/torch_parallel_parity.py (atol 5e-5, rtol
1e-3 against one rank; moments-only against the replicated table on as many
ranks at atol 1e-6, rtol 1e-5, as the JAX test).
"""

import pytest
from torch_parallel_parity import (
    MOMENTS_ATOL,
    MOMENTS_RTOL,
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


def _spec(layout, tmp_path, name):
    cfg, params, _, grid, budget = setup()
    batches = compare.synthetic_batches(64, 3, cfg.n_timesteps, seed=6)
    return spec(cfg, layout, params, grid, batches, tmp_path, name, budget=budget)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One rank here; 2 ranks (ZeRO-3, moments-only, replicated and the two
    JAX steps' jobs) and 4 ranks (ZeRO-3) spawned once each."""
    tmp = tmp_path_factory.mktemp("zero")
    refs = {layout: jax_job(layout, tmp) for layout in ("zero3", "moments")}
    one = run(_spec("zero3", tmp, "one"), 1)
    jobs = [("run_steps", _spec(layout, tmp, f"{layout}2"))
            for layout in ("zero3", "moments", "replicated")]
    jobs += [job for _, job in refs.values()]
    two = spawn_jobs(jobs, 2)
    out = {"one": one, ("zero3", 4): run(_spec("zero3", tmp, "zero3_4"), 4)}
    for (_, s), result in zip(jobs, two):
        key = ("jax", s["layout"]) if s.get("jitters") else (s["layout"], 2)
        out[key] = (result, read_flat(s["out"]))
    out["refs"] = {layout: ref for layout, (ref, _) in refs.items()}
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_zero3_steps_match_one_rank(runs, n):
    """E = 5120 entries divide over 2 and 4 ranks."""
    (one, flat1), (many, flat_n) = runs["one"], runs[("zero3", n)]
    assert one["layout"] == "replicated" and many["layout"] == "zero3"
    assert many["num_budget_dropped"] == one["num_budget_dropped"]
    assert_close(flat_n, flat1)


def test_moments_only_zero_matches_replicated(runs):
    (mom, flat_mom), (_, flat_rep) = runs[("moments", 2)], runs[("replicated", 2)]
    assert mom["layout"] == "moments"
    assert_close(flat_mom, flat_rep, MOMENTS_ATOL, MOMENTS_RTOL)
    assert_close(flat_mom, runs["one"][1])


@pytest.mark.parametrize("layout", ["zero3", "moments"])
def test_zero_step_matches_jax_mesh(runs, layout):
    result, flat = runs[("jax", layout)]
    assert result["layout"] == layout
    assert_step_matches_jax(runs["refs"][layout], result, flat)
