"""Helpers of the tests that hold the port's multi-rank runs to one rank and
to the JAX package's step on a 2-device mesh (tests/test_torch_parallel*.py).

The ranks are spawned processes over gloo (``parallel.launch.spawn``, a
FileStore in a temporary directory); they run the package's
``parallel.compare`` functions and import no JAX. Only this test process
runs the JAX step: ``test_torch_train_step._setup``'s tiny flagship config,
contrast-scaled parameters, 30%-fill grid and overflowing budget, jitted as
``_jax_step`` over ``make_mesh(n)`` with the batch at ``P("data")`` and the
table (or its Adam moments) sharded as the JAX trainer shards them
(trainer.py:183-235).
"""

import copy
import functools

import jax
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P
from test_torch_train_step import LRS, R, SCHED, TOL, _jax_step, _leaves, _setup
from torch_parity import example_rays, to_numpy_tree

import __graft_entry__
from chip_smoke import TINY_VARIANTS
from nersemble_tpu.models.nersemble import NeRSembleModel as JaxModel
from nersemble_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.engine.checkpoints import read_flat
from nersemble_tpu_torch.parallel import compare, launch
from nersemble_tpu_torch.utils.cameras import CONTRAST_SCALES, synthetic_occupancy

# the JAX package's multi-device tolerance at an f32 table
# (tests/test_table_sharding.py:80, 170); here the MLPs compute in f32 too,
# so that the bf16 rounding of partial sums over a rank's rows is not what
# is compared
ATOL, RTOL = 5e-5, 1e-3
# moments-only ZeRO against the replicated table on as many ranks
# (tests/test_table_sharding.py:124)
MOMENTS_ATOL, MOMENTS_RTOL = 1e-6, 1e-5
# a rank waits this long in a collective for a peer that died
TIMEOUT_S = 120.0


def _tables(n):
    def edit(cfg):
        cfg.hash_ensemble.n_hash_encodings = cfg.latent_dim_time = n
    return edit


# the configurations ``variant`` names: chip_smoke.TINY_VARIANTS, and the
# ensemble at 3 and 2 logical tables of 2 features, whose row width of 6 or
# 4 columns over 2 or 4 ranks cuts a logical table between two ranks
VARIANTS = dict(TINY_VARIANTS, three_tables=(_tables(3),), two_tables=(_tables(2),))


def _setup_variant(fraction, variant):
    """``_setup`` at f32 on the tiny flagship config edited as
    ``VARIANTS[variant]`` (None: ``_setup`` itself); the
    contrast scales of the parameters the variant has."""
    if variant is None:
        return _setup("float32", fraction)
    cfg_t = flagship_model_config(tiny=True)
    cfg_j = __graft_entry__._flagship_model_config(tiny=True)
    for cfg in (cfg_t, cfg_j):
        cfg.compute_dtype = cfg.table_dtype = "float32"
        cfg.sampling.global_budget_fraction = fraction
        for edit in VARIANTS[variant]:
            edit(cfg)
    jm = JaxModel(cfg_j)
    params = to_numpy_tree(jm.init_params(jax.random.PRNGKey(0)))
    for key, factor in CONTRAST_SCALES.items():
        *path, leaf = key.split(".")
        node = params
        for part in path:
            node = node.get(part) if isinstance(node, dict) else None
        if node is not None and leaf in node:
            node[leaf] = node[leaf] * factor
    rng = np.random.default_rng(3)
    batch = example_rays(R, 8, seed=1)
    batch["rgb"] = rng.uniform(size=(R, 3)).astype(np.float32)
    batch["alpha"] = rng.uniform(size=R).astype(np.float32)
    batch["depth"] = rng.uniform(7.5, 9.5, R).astype(np.float32)
    grid = synthetic_occupancy(16, 0.3, seed=0)
    budget = -(-int(R * 16 * fraction) // 128) * 128
    return cfg_t, jm, params, batch, grid, budget


@functools.lru_cache(maxsize=None)
def _setup_cached(fraction, variant=None):
    return _setup_variant(fraction, variant)


def setup(fraction=0.5, variant=None):
    """(port config, params, batch, grid, budget) at f32: the port's half
    of ``_setup`` (of ``variant``, a key of ``VARIANTS``), made
    once (a fresh copy of the config per call)."""
    cfg_t, _, params, batch, grid, budget = _setup_cached(fraction, variant)
    batch = dict(batch, timesteps=batch["timesteps"].astype(np.int64))
    return copy.deepcopy(cfg_t), params, batch, grid, budget


def spec(cfg, layout, params, grid, batches, tmp_path, name, **extra):
    return {"config": cfg, "layout": layout, "params": params,
            "grid_occs": grid, "batches": batches,
            "out": str(tmp_path / f"{name}.ckpt"), **extra}


def spawn_jobs(jobs, n):
    """``compare.run_many(jobs)`` on ``n`` gloo ranks; each run_steps
    result checked for equal replicas and no JAX in the ranks."""
    results = launch.spawn(compare.run_many, n, "gloo", "cpu", jobs,
                           timeout_s=TIMEOUT_S)
    for (name, _), result in zip(jobs, results):
        if name == "run_steps":
            assert result["replicas_equal"], "the ranks' replicas differ"
            assert result["jax_imported"] is False
    return results


def run(spec_, n):
    """``compare.run_steps`` on ``n`` gloo ranks (1: in this process);
    (result, checkpoint arrays)."""
    if n == 1:
        result = compare.run_steps(None, spec_)
    else:
        result = spawn_jobs([("run_steps", spec_)], n)[0]
    return result, read_flat(spec_["out"])


def assert_close(a, b, atol=ATOL, rtol=RTOL):
    bad = {k: v for k, v in compare.max_violation(a, b, atol, rtol).items() if v > 1}
    assert not bad, bad


def jax_step(layout, n=2, variant=None):
    """One JAX step over ``make_mesh(n)`` in ``layout``'s shardings (of
    ``variant``'s configuration); returns (setup, jitter, total, losses,
    grads, new params, mu, nu, dropped) with the trees as flat ``a.b.c``
    numpy dicts."""
    cfg_t, jm, params, batch, grid, budget = _setup_variant(0.5, variant)
    batch = dict(batch, timesteps=batch["timesteps"].astype(np.int64))
    mesh = make_mesh(n)
    rep = replicated(mesh)
    entry, feature = NamedSharding(mesh, P("data", None)), NamedSharding(mesh, P(None, "data"))
    table = {"zero3": entry, "tp": feature}.get(layout, rep)
    moments = {"zero3": entry, "moments": entry, "tp": feature}.get(layout, rep)
    if layout == "zero3":
        jm.table_replicate_sharding = rep

    def put(tree, table_sharding):
        return jax.tree_util.tree_map_with_path(
            lambda path, leaf: jax.device_put(leaf, table_sharding if tuple(
                getattr(k, "key", None) for k in path)[:2] == ("field", "table") else rep),
            tree)

    opt = optax.scale_by_adam(eps=1e-15).init(params)
    opt = type(opt)(count=jax.device_put(opt.count, rep), mu=put(opt.mu, moments),
                    nu=put(opt.nu, moments))
    jparams = put(jax.tree_util.tree_map(np.asarray, params), table)
    jbatch = {k: jax.device_put(v, batch_sharding(mesh)) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)
    jitter = np.asarray(jax.random.uniform(key, (R,)))  # render_rays' own draw
    total, losses, grads, new, state, dropped = _jax_step(
        jm, jparams, opt, grid, jbatch, key, budget)
    if layout != "replicated":
        leaf = new["field"]["table"] if layout != "moments" else state.mu["field"]["table"]
        assert not leaf.sharding.is_fully_replicated, layout
    return ((cfg_t, params, batch, grid, budget), jitter, total, losses,
            _leaves(grads), _leaves(new), _leaves(state.mu), _leaves(state.nu),
            dropped)


def jax_job(layout, tmp_path, n=2, variant=None):
    """The JAX step of ``layout`` over ``n`` devices and the port's job of
    the same step: (reference, ("run_steps", spec))."""
    ref = jax_step(layout, n, variant)
    (cfg, params, batch, grid, budget), jitter = ref[:2]
    job = spec(cfg, layout, params, grid, [batch], tmp_path,
               f"{layout}_jax" if variant is None else f"{layout}_{variant}_jax",
               jitters=[jitter], sched=SCHED, lrs=LRS, budget=budget)
    return ref, ("run_steps", job)


def assert_step_matches_jax(ref, result, flat):
    """The port's step (``result`` and its checkpoint arrays ``flat``)
    against the JAX step ``ref`` of ``jax_job``, at test_torch_train_step's
    f32 bounds: losses to rtol 1e-4, the Adam moments (0.1 g and 0.001 g^2
    after one step) to rtol 1e-3 with an atol of 1e-4 of the gradient's
    max, the update wherever |g| is above 100x that atol."""
    (cfg, params, batch, grid, budget), jitter, j_total, j_losses, j_g, j_p, \
        j_mu, j_nu, j_dropped = ref
    loss_rtol, g_rtol, g_atol = TOL["float32"]
    assert result["num_budget_dropped"][0] == j_dropped > 0  # it overflowed
    losses = result["losses"][0]
    assert losses.keys() == j_losses.keys() and len(losses) == 6
    for k, v in losses.items():
        assert abs(v - j_losses[k]) <= loss_rtol * abs(j_losses[k]) + 1e-9, k
    assert abs(result["loss"][0] - j_total) <= loss_rtol * abs(j_total)
    before = _leaves(params)
    for k, g in j_g.items():
        key = k.replace(".", "/")
        atol = g_atol * np.abs(g).max()
        np.testing.assert_allclose(flat[f"opt_state/mu/{key}"], j_mu[k],
                                   rtol=g_rtol, atol=0.1 * atol, err_msg=f"mu {k}")
        np.testing.assert_allclose(flat[f"opt_state/nu/{key}"], j_nu[k],
                                   rtol=2 * g_rtol, atol=1e-3 * atol * np.abs(g).max(),
                                   err_msg=f"nu {k}")
        lr = LRS[{"field": "fields", "deformation": "deformation_field"}.get(
            k.split(".")[0], "embeddings")]
        upd = (before[k] - flat[f"params/{key}"]) / lr
        j_upd = (before[k] - j_p[k]) / lr
        sure = np.abs(g) > 100 * atol
        np.testing.assert_allclose(upd[sure], j_upd[sure], rtol=1e-3, atol=1e-3,
                                   err_msg=f"update {k}")
