"""The dense march (occupancy grid off; the reference README's sequence-97
recipe) on the port, on the CPU at a tiny size.

- The README's two flags build S = the comb that spans the scene box and a
  budget that drops nothing; explicit flags stay; the flagship's flags build
  today's model.
- No ray stops inside the box, and a step evaluates its valid samples and
  no others (padding under 256 rows), read by the tracer's counters and its
  ``render:chunk`` spans; the adaptive budget stays out.
- The port's float32 step against the benchmark's plain reference
  (``benchmark/reference/nersemble_seq97_ref.py``) on seeded weights: the
  losses, the sample counts, the first gradient and three Adam updates
  within the tolerances below, which a bfloat16 reference fails.
"""

import json
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference.nersemble_ref import step_lrs
from benchmark.reference.nersemble_seq97_ref import DenseReference
from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.data.dataparser import scene_box
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.models.nersemble import NeRSembleModel
from nersemble_tpu_torch.ops.sampling import (
    box_span,
    candidates_to_span,
    dense_budget,
    march_rays,
    spanning_comb,
)
from nersemble_tpu_torch.scripts.train_nersemble import build_config, build_parser
from nersemble_tpu_torch.utils import spans
from nersemble_tpu_torch.utils.params import ParamTree

ROOT = Path(__file__).resolve().parent.parent
README = ["--disable-occupancy-grid", "--lambda-dist-loss", "0"]
SEED = 2 ** 31 + 977
STEP = 80016  # past every schedule
RAYS = 64
B1 = 0.9

# The float32 program against the float32 reference: the same operations,
# summed in another order (the hash table's gradient by the port's row
# gathers, the losses per block), so float32 rounding alone: the first
# gradient and the updates read 3e-7 to 5e-7 here, the losses and colours
# 0. Each limit leaves at least twenty times that. The reference in
# bfloat16 rounds the table, the MLPs' operands and the gradients through
# them to 8 bits and reads 1.5e-2 (grad), 6.7e-3 (table), 0.17 (update)
# and 3.4e-5 (colour).
TOL = {
    "loss": 1e-5,    # a step's total loss, relative
    "grad": 1e-5,    # the first gradient: median leaf of ||g - g_ref|| / ||g_ref||
    "table": 1e-4,   # the table's leaf alone: a sum over many more rows
    "update": 1e-4,  # the change after three Adam steps, median leaf likewise
    "colour": 1e-5,  # the first step's colour, largest gap of a channel
}


def _flags(*extra):
    return build_config(build_parser().parse_args(["30", "SYN-1", *extra]), "r", "/m")


def test_readme_flags_build_a_box_spanning_march_that_drops_nothing():
    model = _flags(*README).model
    assert model.disable_occupancy_grid and model.lambda_dist_loss == 0.0
    # participant 30's box: a 7.44-unit diagonal, 677 steps of 0.011
    assert candidates_to_span(box_span(scene_box(30, 9.0)), 0.011) == 677
    assert model.sampling.max_samples_per_ray == 768
    assert model.sampling.global_budget_fraction == 1.0
    model.scene_box = scene_box(30, 9.0).tolist()
    auto = NeRSembleModel(model, "cpu").config.sampling.max_candidates_per_ray
    assert auto == model.sampling.max_samples_per_ray
    # participant 97, whose sequence the README trains so: 731 steps
    assert build_config(build_parser().parse_args(["97", "SEQ", *README]), "r", "/m") \
        .model.sampling.max_samples_per_ray == 768


@pytest.mark.parametrize("participant,cone,levels",
                         [(30, "0.0", "1"), (97, "0.0", "1"), (30, "0.004", "1"),
                          (30, "0.0", "2")])
def test_the_cli_takes_the_models_own_comb(participant, cone, levels):
    """The README's flags size S to the candidate count the model auto-sizes
    on the participant's box, with a cone angle or a cascade too."""
    args = [str(participant), "SEQ", *README, "--cone-angle", cone, "--grid-levels", levels]
    model = build_config(build_parser().parse_args(args), "r", "/m").model
    model.scene_box = scene_box(participant, 9.0).tolist()
    auto = NeRSembleModel(model, "cpu").config.sampling.max_candidates_per_ray
    assert model.sampling.max_samples_per_ray == auto
    assert auto == spanning_comb(model.scene_box, int(levels), model.render_step_size,
                                 float(cone), model.near_plane)


def test_explicit_flags_stay_and_the_flagship_builds_todays_model():
    model = _flags(*README, "--max-samples-per-ray", "300",
                   "--global-budget-fraction", "0.5").model
    assert model.sampling.max_samples_per_ray == 300
    assert model.sampling.global_budget_fraction == 0.5
    flagship = json.loads(json.dumps(_flags("--n-timesteps", "16", "--vis", "none")
                                     .model.to_dict()))
    want = json.loads((ROOT / "benchmark/configs/nersemble.json").read_text())["model"]
    filled_later = ("scene_box", "num_images")  # from the capture
    assert {k: v for k, v in flagship.items() if k not in filled_later} == \
        {k: v for k, v in want.items() if k not in filled_later}
    assert flagship["sampling"]["max_samples_per_ray"] == 256
    assert flagship["sampling"]["global_budget_fraction"] == 0.125


def test_no_ray_stops_inside_the_box():
    """Rays along the box's diagonals, the longest path through it."""
    box = torch.from_numpy(scene_box(30, 9.0))
    S = _flags(*README).model.sampling.max_samples_per_ray
    corners = torch.tensor([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=torch.float32)
    lo, hi = box[0] + corners * (box[1] - box[0]), box[1] - corners * (box[1] - box[0])
    d = (hi - lo) / (hi - lo).norm(dim=-1, keepdim=True)
    o = lo - d * 1e-3
    for jitter in (torch.zeros(4), torch.full((4,), 0.999)):
        samples, info = march_rays(o, d, box[0], box[1], 0.011, S, S, jitter=jitter)
        assert int(info["n_dropped_per_ray"].max()) == 0
        assert int(samples.mask.sum(1).min()) >= 670  # 7.44 units of 0.011
        _, capped = march_rays(o, d, box[0], box[1], 0.011, S, 256, jitter=jitter)
        assert int(capped["n_dropped_per_ray"].min()) > 400  # the old S stopped them


def test_dense_budget_rounds_up_to_256_rows():
    assert [dense_budget(n, 10 ** 6) for n in (0, 1, 256, 257, 99_841)] == \
        [256, 256, 256, 512, 100_096]
    assert dense_budget(999, 768) == 768


# ---------------------------------------------------------------------------
# a tiny dense step
# ---------------------------------------------------------------------------

def _config(chunk=2 ** 16):
    cfg = flagship_model_config(tiny=True)
    cfg.disable_occupancy_grid = True
    cfg.lambda_dist_loss = 0.0
    cfg.compute_dtype = cfg.table_dtype = "float32"
    cfg.sampling.global_budget_fraction = 1.0
    cfg.sampling.max_samples_per_ray = spanning_comb(cfg.scene_box, 1, cfg.render_step_size)
    cfg.max_n_samples_per_batch = chunk
    return cfg


def _batch(n_timesteps, step):
    rng = np.random.default_rng(step)
    d = rng.normal(size=(RAYS, 3)) * [0.05, 0.3, 0.3] + [1.0, 0.0, 0.0]
    b = {"origins": np.tile(np.float32([[-8.0, 0.5, 0.0]]), (RAYS, 1)),
         "directions": (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32),
         "timesteps": rng.integers(0, n_timesteps, RAYS),
         "rgb": rng.uniform(size=(RAYS, 3)).astype(np.float32),
         "alpha": np.where(rng.uniform(size=RAYS) < 0.3, 1.0,
                           rng.uniform(size=RAYS)).astype(np.float32),
         "depth": rng.uniform(7.5, 11.0, RAYS).astype(np.float32)}
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _trainer(cfg, flat):
    return NeRSembleTrainer(cfg, n_rays=RAYS, device="cpu", seed=SEED % 2 ** 30,
                            params=ParamTree(weights.nested(
                                {k: v.clone() for k, v in flat.items()})))


@pytest.fixture(scope="module")
def program():
    """Three steps of the port's float32 dense step: losses, counts, the
    first gradient (Adam's first moment over 1 - b1), the changes, and
    the first step's colour."""
    cfg = _config()
    m = json.loads(json.dumps(cfg.to_dict()))
    flat = weights.make(m, SEED, "cpu")
    trainer = _trainer(cfg, flat)
    colours = []
    render = trainer.model.render_rays

    def keep_colour(*a, **k):
        out = render(*a, **k)
        colours.append(out["rgb"].detach().clone())
        return out
    trainer.model.render_rays = keep_colour
    out = {"losses": [], "valid": [], "dropped": [], "m": m, "flat": flat,
           "optimizers": {k: v.to_dict() for k, v in trainer.optimizers.items()}}
    for k in range(3):
        total, aux = trainer.run_step(STEP + k, _batch(cfg.n_timesteps, STEP + k))
        out["losses"].append(float(total))
        out["valid"].append(int(aux["num_samples"]))
        out["dropped"].append(int(aux["num_budget_dropped"]))
        if k == 0:
            out["grads"] = {n: mu.detach() / (1 - B1)
                            for n, mu in trainer.opt_state.mu.named_parameters()}
    out["colour"] = colours[0]
    out["params"] = {k: v.detach() for k, v in trainer.params.named_parameters()}
    out["budget"] = trainer._budget
    return out


def _reference(program, quant=None):
    m = program["m"]
    ref = DenseReference(m, "cpu", **({} if quant is None else {"quant": quant}),
                         block_samples=4096)
    params = {k: v.clone() for k, v in program["flat"].items()}
    state, out = {}, {"losses": [], "valid": []}
    for k in range(3):
        loss, grads, n_valid, _, colour = ref.step(
            params, state, _batch(m["n_timesteps"], STEP + k), ref.binaries(None),
            STEP + k, SEED % 2 ** 30, step_lrs(program["optimizers"], STEP + k))
        out["losses"].append(loss)
        out["valid"].append(n_valid)
        if k == 0:
            out["grads"], out["colour"] = grads, colour
    out["params"] = params
    return out


def _gaps(program, ref):
    """The compared numbers (``TOL``'s keys)."""
    def rel(a, b):
        return float((a - b).detach().norm() / b.detach().norm().clamp(min=1e-30))

    grads = {k: rel(program["grads"][k], g) for k, g in ref["grads"].items()
             if g is not None and float(g.norm()) > 0}
    start = program["flat"]
    moves = {k: rel(program["params"][k] - start[k], ref["params"][k] - start[k])
             for k in grads}
    return {"loss": max(abs(a - b) / abs(b) for a, b in
                        zip(program["losses"], ref["losses"])),
            "grad": statistics.median(grads.values()), "table": grads["field.table"],
            "update": statistics.median(moves.values()),
            "colour": float((program["colour"] - ref["colour"]).abs().max())}


def test_the_dense_step_evaluates_every_valid_sample(program):
    assert all(v > 1000 for v in program["valid"])  # the rays cross the box
    assert program["dropped"] == [0, 0, 0]
    assert program["budget"] == RAYS * _config().sampling.max_samples_per_ray


def test_the_dense_step_matches_the_reference(program):
    ref = _reference(program)
    assert program["valid"] == ref["valid"]
    gaps = _gaps(program, ref)
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps


def test_a_bfloat16_reference_fails_the_tolerances(program):
    def bf16(x):
        return x.to(torch.bfloat16).to(x.dtype)
    ref = _reference(program, quant=bf16)
    gaps = _gaps(program, ref)
    assert any(gaps[k] > TOL[k] for k in TOL), gaps


def test_counters_and_chunk_spans_count_a_dense_step():
    spans.reset()
    cfg = _config(chunk=4096)
    m = json.loads(json.dumps(cfg.to_dict()))
    trainer = _trainer(cfg, weights.make(m, SEED, "cpu"))
    batch = _batch(cfg.n_timesteps, STEP)
    trainer.run_step(STEP, batch)  # off: nothing counted
    assert not any(k.startswith(("samples_", "field_")) for k in spans.counters())
    spans.enable("cpu")
    try:
        total, aux = trainer.run_step(500, batch)  # the adaptive budget's cadence
    finally:
        spans.disable()
    counts, exported = spans.counters(), spans.export()["spans"]
    spans.reset()
    valid = int(aux["num_samples"])
    rows = dense_budget(valid, RAYS * cfg.sampling.max_samples_per_ray)
    assert counts["samples_valid"] == valid and counts["samples_budget_dropped"] == 0
    assert counts["samples_evaluated"] == rows and rows - valid < 256
    chunks = [s for s in exported if s["name"] == "render:chunk"]
    assert counts["field_chunks"] == len(chunks) == -(-rows // 4096)
    field = next(s for s in exported if s["name"] == "render:field")
    assert all(c["parent"] == field["id"] for c in chunks)
    # one host read a step, under its own span; the budget read none
    assert counts["host_syncs.render:size"] == 1
    assert not any(k.startswith("host_syncs.loop:budget") for k in counts)
    assert trainer._budget == RAYS * cfg.sampling.max_samples_per_ray


def test_counters_count_the_flagships_budget_drops():
    """The grid's path: the compaction drops what the budget cannot hold,
    counted without a host read."""
    spans.reset()
    cfg = flagship_model_config(tiny=True)
    cfg.sampling.global_budget_fraction = 0.125
    m = json.loads(json.dumps(cfg.to_dict()))
    trainer = _trainer(cfg, weights.make(m, SEED, "cpu"))
    trainer.grid_occs = torch.ones_like(trainer.grid_occs)
    spans.enable("cpu")
    try:
        total, aux = trainer.run_step(STEP + 1, _batch(cfg.n_timesteps, STEP))
    finally:
        spans.disable()
    counts = spans.counters()
    spans.reset()
    assert counts["samples_valid"] == int(aux["num_samples"])
    assert counts["samples_evaluated"] == trainer._budget
    assert counts["samples_budget_dropped"] == int(aux["num_budget_dropped"]) > 0
    assert not any(k.startswith("host_syncs") for k in counts)
