"""ROADMAP C9's CPU rehearsal at the trainer level: both packages'
``NeRSembleTrainer`` on the tiny dynamic configuration (the hash ensemble
of 4 tables, the SE(3) deformation field, 4 timesteps of
tests/synthetic_data.py's capture, f32), from the same parameters, with
the same batches (each package's step-indexed ``RayBatcher``, held equal),
and with JAX's own draws injected into the port: the jitter of step k
(nersemble_tpu/engine/trainer.py:255) and the occupancy update's samples
(:321), drawn from the JAX trainer's key as its jitted functions draw them.

The run covers the trainer's cadence: the occupancy grid's EMA update
every 16 steps (all cells during the warm-up of 20 steps, then sampled),
the adaptive budget (interval 8: decisions every 8 steps and the fast
growth in between), the hash fade-in from 1 to 4 tables over steps 4-36,
the deformation window to step 20 and the eps-depth anneal to step 30.
The learning rates are a fifth of the defaults (1e-3 for the fields and
the embeddings, 3e-4 for the deformation field): at the defaults this
tiny run has loss spikes, in both packages alike, that grow the f32
differences of the two runs past the loss bounds from about step 130.
Each step runs what each trainer's loop runs: the occupancy update, the
train step, the budget decision. Compared at every step, the first step
and the quantity that part named:

- ``sched_values``: equal;
- the budget after each decision: equal;
- the occupancy binaries after each update: at most OCC_CELLS of the
  cells differ. A cell probed twice in one update keeps the port's
  largest candidate and XLA's last (ROADMAP C6), and a cell at the
  threshold flips with the parameters' f32 drift. After each count the
  port takes JAX's grid, so that the C6 difference does not seed a
  divergence of the two runs that the comparison would then measure;
- the total loss: within tests/test_torch_train_step.py's f32 loss rtol
  for the first LOSS_STEPS steps, and the mean of the last WINDOW steps
  within END_RTOL.

``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dynamic_rehearsal.py -s``
prints each run's report; the ``slow`` test (``-m slow``) runs SLOW_STEPS
steps, and there the loss must also fall to half its start.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import TOL
from torch_parity import n, t

import nersemble_tpu_torch.env as tenv
from nersemble_tpu.engine.trainer import NeRSembleTrainer as JaxTrainer
from nersemble_tpu.ops import fused_mlp as jfm
from nersemble_tpu.scripts import train_nersemble as jcli
from nersemble_tpu_torch.engine import trainer as trainer_module
from nersemble_tpu_torch.engine.checkpoints import params_from_numpy
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.ops.occupancy import OccupancyDraws
from nersemble_tpu_torch.scripts import train_nersemble as tcli
from tests.synthetic_data import make_synthetic_dataset

STEPS, SLOW_STEPS = 40, 300
N_TIMESTEPS = 4
ARGS = ["30", "SYN-1", "--n-train-rays", "64", "--num-levels", "4",
        "--log2-hashmap-size", "9", "--max-res", "32", "--grid-resolution", "16",
        "--n-hash-encodings", "4", "--latent-dim-time", "4",
        "--latent-dim-time-deform", "8", "--mlp-num-layers", "2",
        "--mlp-layer-width", "16", "--max-samples-per-ray", "24",
        "--max-candidates-per-ray", "-1", "--window-deform-end", "20",
        "--window-hash-encodings-begin", "4", "--window-hash-encodings-end", "36",
        "--eps-depth-end-step", "30", "--global-budget-fraction", "0.25",
        "--adaptive-budget-max-chunks", "3", "--lr-main", "1e-3",
        "--lr-embeddings", "1e-3", "--lr-deformation-field", "3e-4", "--vis", "none"]
OCC_WARMUP, BUDGET_INTERVAL = 20, 8
LOSS_RTOL = TOL["float32"][0]
LOSS_STEPS = 20
WINDOW, END_RTOL = 10, 0.05
# the share of the grid's cells whose binaries may differ after an update
OCC_CELLS = 0.005
BATCH_KEYS = ("origins", "directions", "rgb", "timesteps", "camera_indices",
              "alpha", "depth")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("rehearsal")
    make_synthetic_dataset(root / "data", n_timesteps=N_TIMESTEPS)
    return root


def _configs(root):
    configs = []
    for cli in (jcli, tcli):
        config = cli.build_config(cli.build_parser().parse_args(ARGS), "rehearsal",
                                  str(root))
        config.model.compute_dtype = config.model.table_dtype = "float32"
        config.model.occupancy_grid_warmup_steps = OCC_WARMUP
        config.model.sampling.adaptive_budget_interval = BUDGET_INTERVAL
        configs.append(config)
    return configs


def _jax_draws(base, step, n_cells, n_timesteps, warmup) -> OccupancyDraws:
    """The samples the JAX trainer's occupancy update of ``step`` draws
    (nersemble_tpu/ops/occupancy.update_occupancy_grid and the model's
    ``occ_eval_fn``)."""
    key = jax.random.split(jax.random.fold_in(base, step))[0]
    pos, tim, uni, occ = jax.random.split(key, 4)
    m = n_cells if warmup else 2 * (n_cells // 4)
    extra = {} if warmup else {
        "uniform_idx": t(jax.random.randint(uni, (n_cells // 4,), 0, n_cells,
                                            jnp.int32)).long(),
        "occupied_u": t(jax.random.uniform(occ, (n_cells // 4,)))}
    return OccupancyDraws(cell_jitter=t(jax.random.uniform(pos, (m, 3))),
                          timesteps=t(jax.random.randint(tim, (m,), 0, n_timesteps)).long(),
                          **extra)


def _jax_step(jt, step: int, host_batch):
    """The body of the JAX trainer's loop (trainer.py:540-560) at ``step``."""
    step_idx = np.int32(step)
    jt.maybe_update_occupancy(step, step_idx)
    if jt._budget not in jt._train_steps:
        jt._train_steps[jt._budget] = jt._make_train_step(jt._budget)
    jt.params, jt.opt_state, total, aux = jt._train_steps[jt._budget](
        jt.params, jt.opt_state, jt.grid_occs, jt.grid_mask,
        jt._device_batch(host_batch), jt.sched_values(step), jt.lr_values(step),
        step_idx)
    jt._maybe_adapt_budget(step, aux)
    return float(total)


def rehearse(root, steps: int) -> dict:
    """Both trainers over ``steps`` steps; the per-step report. The port
    runs on two torch threads: the tiny run's ops gain nothing from more,
    and the tier-1 run's workers share the host's cores."""
    config_j, config_t = _configs(root)
    saved = jfm.INTERPRET, tenv.NERSEMBLE_DATA_PATH, torch.get_num_threads()
    jfm.INTERPRET, tenv.NERSEMBLE_DATA_PATH = True, str(root / "data")
    torch.set_num_threads(2)
    try:
        jt = JaxTrainer(config_j, data_location=str(root / "data"))
        tt = NeRSembleTrainer.from_train_config(config_t, device="cpu")
        return _run(jt, tt, steps)
    finally:
        jfm.INTERPRET, tenv.NERSEMBLE_DATA_PATH = saved[:2]
        torch.set_num_threads(saved[2])


def _run(jt, tt, steps: int) -> dict:
    tt._set_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, jt.params), "cpu"))
    tt.opt_state = tt._init_adam()
    tt.grid_occs = t(np.asarray(jt.grid_occs))
    assert np.array_equal(n(tt.grid_mask), np.asarray(jt.grid_mask))
    base = jax.random.PRNGKey(jt.config.seed + 1)  # the JAX trainer's draws
    R, T = jt.config.data.train_num_rays_per_batch, jt.config.data.n_timesteps
    report = {"steps": steps, "loss": [], "loss_jax": [], "budget": [],
              "budget_jax": [], "sched": [], "sched_parts": None, "batch_parts": None,
              "occupancy": [], "start": tt._budget == jt._budget}
    current = {}

    def draws(n_cells, n_timesteps, warmup, generator):
        return _jax_draws(base, current["step"], n_cells, n_timesteps, warmup)

    start = time.perf_counter()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_module, "draw_occupancy", draws)
        for step in range(steps):
            current["step"] = step
            ours = {k: np.float32(v) for k, v in tt.sched_values(step).items()}
            theirs = {k: np.float32(v) for k, v in jt.sched_values(step).items()}
            if report["sched_parts"] is None and ours != theirs:
                report["sched_parts"] = (step, ours, theirs)
            report["sched"].append(ours)
            host = jt.batcher.batch_for_step(step)
            mine = tt.batcher.batch_for_step(step)
            if report["batch_parts"] is None and any(
                    not np.array_equal(host[k], mine[k]) for k in host):
                report["batch_parts"] = step
            report["loss_jax"].append(_jax_step(jt, step, host))
            # the port's loop body (NeRSembleTrainer.run_step) with JAX's jitter
            tt.maybe_update_occupancy(step)
            if step % trainer_module.OCC_UPDATE_EVERY == 0:
                a = n(tt.model.binaries(tt.grid_occs)).reshape(-1)
                b = np.asarray(jt.model.binaries(jt.grid_occs)).reshape(-1)
                report["occupancy"].append((step, int((a != b).sum()), a.size,
                                            int(b.sum())))
                tt.grid_occs = t(np.asarray(jt.grid_occs))
            jitter = t(np.asarray(jax.random.uniform(
                jax.random.split(jax.random.fold_in(base, step))[1], (R,))))
            batch = {k: torch.from_numpy(v) for k, v in host.items() if k in BATCH_KEYS}
            total, aux = tt.train_step(step, batch, jitter=jitter)
            tt._maybe_adapt_budget(step, aux)
            report["loss"].append(float(total))
            report["budget"].append(tt._budget)
            report["budget_jax"].append(jt._budget)
    report["seconds"] = time.perf_counter() - start
    report["n_timesteps"] = T
    return report


def _first(flags):
    bad = np.flatnonzero(flags)
    return int(bad[0]) if bad.size else None


def check(report: dict, learns: float = None) -> None:
    """The comparisons of the module docstring; each failure names the
    first step and the quantity that part. ``learns``: the mean loss of
    the last WINDOW steps must also be below this share of the first's."""
    assert report["start"], "the trainers start at different budgets"
    assert report["batch_parts"] is None, f"the batches part at step {report['batch_parts']}"
    assert report["sched_parts"] is None, \
        f"sched_values part at step {report['sched_parts'][0]}: {report['sched_parts'][1:]}"
    budget, budget_jax = np.array(report["budget"]), np.array(report["budget_jax"])
    step = _first(budget != budget_jax)
    assert step is None, (f"the budget decisions part at step {step}: port "
                          f"{budget[step]}, JAX {budget_jax[step]}")
    assert len(set(budget_jax)) > 1, "no budget decision changed the budget"
    for step, differ, cells, on in report["occupancy"]:
        assert differ <= OCC_CELLS * cells, (
            f"the occupancy update of step {step}: {differ} of {cells} cells' "
            f"binaries differ (bound {OCC_CELLS * cells:.0f})")
    loss, loss_jax = np.array(report["loss"]), np.array(report["loss_jax"])
    rel = np.abs(loss - loss_jax) / np.abs(loss_jax)
    step = _first(rel[:LOSS_STEPS] > LOSS_RTOL)
    assert step is None, (f"the losses part at step {step}: port {loss[step]}, JAX "
                          f"{loss_jax[step]} (rtol {LOSS_RTOL})")
    end, end_jax = loss[-WINDOW:].mean(), loss_jax[-WINDOW:].mean()
    assert abs(end - end_jax) <= END_RTOL * abs(end_jax), (
        f"the mean loss of the last {WINDOW} steps parts: port {end}, JAX {end_jax}")
    if learns is not None:
        assert end_jax < learns * loss_jax[:WINDOW].mean(), "the JAX run did not learn"


def _summary(report: dict) -> dict:
    loss, loss_jax = np.array(report["loss"]), np.array(report["loss_jax"])
    rel = np.abs(loss - loss_jax) / np.abs(loss_jax)
    return {"steps": report["steps"], "seconds": round(report["seconds"], 1),
            "first_loss_step_past_rtol": _first(rel > LOSS_RTOL),
            "max_rel_loss_gap_first_steps": float(rel[:LOSS_STEPS].max()),
            "end_loss": float(loss[-WINDOW:].mean()),
            "end_loss_jax": float(loss_jax[-WINDOW:].mean()),
            "budgets": sorted(set(report["budget_jax"])),
            "occupancy_cells_differing": [(s, d) for s, d, _, _ in report["occupancy"]]}


@pytest.fixture(scope="module")
def short_run(capture):
    report = rehearse(capture, STEPS)
    print(f"\ntrainer rehearsal: {_summary(report)}")
    return report


def test_trainer_rehearsal_holds_the_cadence_to_jax(short_run):
    check(short_run)


def test_trainer_rehearsal_covers_the_cadence(short_run):
    """The run reaches what it is meant to hold: updates in and after the
    warm-up, a budget decision, the fade-in across tables, the windows'
    ends."""
    steps = [s for s, _, _, _ in short_run["occupancy"]]
    assert steps == [0, 16, 32] and 16 < OCC_WARMUP < 32
    assert len(set(short_run["budget_jax"])) > 1
    sched = short_run["sched"]
    hash_window = [s["window_hash"] for s in sched]
    assert hash_window[0] == 1.0 and hash_window[-1] == 4.0  # 3 tables faded in
    assert sched[0]["window_deform"] < sched[-1]["window_deform"] == sched[30]["window_deform"]
    assert sched[0]["eps_depth"] > sched[-1]["eps_depth"] == sched[30]["eps_depth"]


@pytest.mark.slow
def test_dynamic_rehearsal_tracks_jax(capture):
    report = rehearse(capture, SLOW_STEPS)
    print(f"\nC9 rehearsal: {_summary(report)}")
    check(report, learns=0.5)
