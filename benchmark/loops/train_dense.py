"""The training loop of a dense march (the occupancy grid off), as one
benchmark cell drives it, and the comparison that decides its ``correct``.

Set-up, window and log cadence are ``loops/train.py``'s ``TrainCell``:
the port's train CLI's configuration of the cell's flags, the capture,
its ``RayBatcher`` through ``DeviceBatches``, the seeded weights and a
``NeRSembleTrainer`` at the traffic's start step, driven by ``run_step``.
With the grid off the trainer makes no occupancy update and reads no
grid: a ray marches through the frustum grid alone. So the starting
grid is every cell occupied, as a march without a grid reads it, and not
the reference's probe of every cell that ``TrainCell.build`` makes.
Each step evaluates all of its valid samples (the train CLI sizes the
march and the budget, ``NeRSembleModel.evaluates_valid_samples``).

Before anything is built, the flags' sampling is held to the
configuration file's: a program whose CLI builds another march (fewer
samples a ray, a budget that drops samples) refuses the cell at once.

A window step whose loss is not finite, or whose budget dropped a valid
sample, counts in ``failed``: both are read on the card, summed there and
read once after the window. ``--trace 1`` times the window's layers
as ``loops/train.py`` does (``trace.LayerTimers``, the steps' evaluated
counts), for the flagship's readers of the same layers; then
``spans_steps`` steps run with the port's tracer on (``utils/spans.py``),
whose counters and ``render:chunk`` spans the dense readers read; the
timers are off there, as their brackets would add to a chunk's host
time. A torch.profiler segment follows.

The check (``run_reference``, ``numbers``) is ``check.py``'s without the
occupancy update: the reference (``reference/nersemble_seq97_ref.py``)
works out the first ``check_steps`` steps from the seeded weights and
the program's batches, marching through the frustum grid alone and
keeping every valid sample; the numbers are ``check.py``'s but
``occupancy``.
"""

import json
import time
from typing import Dict

import torch

from benchmark import check, weights
from benchmark.loops import train as train_loop
from benchmark.loops.train import TrainCell, log, trainer_seed
from benchmark.reference.nersemble_ref import Reference, identity, step_lrs
from benchmark.reference.nersemble_seq97_ref import DenseReference

# what the configuration file's model holds and the flags have to build
SAMPLING = ("max_samples_per_ray", "max_candidates_per_ray", "global_budget_fraction")


def check_sampling(cfg: Dict) -> None:
    """Raises unless the port's train CLI builds the file's march from its
    flags: the grid, the distortion loss, the samples a ray and the
    budget (a configuration without its ``model`` is held to nothing)."""
    if "model" not in cfg:
        return
    from nersemble_tpu_torch.scripts.train_nersemble import build_config, build_parser

    built = build_config(build_parser().parse_args(cfg["train_cli"]), "benchmark", "")
    model = json.loads(json.dumps(built.model.to_dict()))
    want = cfg["model"]
    got = {k: model[k] for k in ("disable_occupancy_grid", "lambda_dist_loss")}
    got.update({k: model["sampling"][k] for k in SAMPLING})
    expected = {k: want[k] for k in ("disable_occupancy_grid", "lambda_dist_loss")}
    expected.update({k: want["sampling"][k] for k in SAMPLING})
    if got != expected:
        raise ValueError(f"the port's train CLI builds {got} from {cfg['train_cli']}, "
                         f"the configuration is {expected}")


class _Unprobed(Reference):
    """The reference with, as its starting grid, every cell occupied: a
    march without a grid probes none."""

    def probe_every_cell(self, p, seed: int, step: int, chunk: int = 16384) -> torch.Tensor:
        m = self.m
        return torch.ones(m["grid_levels"] * m["grid_resolution"] ** 3, device=self.device)


class DenseTrainCell(TrainCell):
    """``TrainCell`` without the starting grid's probe, with the window's
    failed steps counted on the card."""

    failures = None  # [] int64 on the device while the window runs

    def build(self) -> None:
        check_sampling(self.cfg)
        probing = train_loop.Reference  # whose grid TrainCell.build seeds
        train_loop.Reference = _Unprobed
        try:
            super().build()
        finally:
            train_loop.Reference = probing

    def one_step(self):
        batch, total, aux = super().one_step()
        if self.failures is not None:
            dropped = torch.as_tensor(aux["num_budget_dropped"], device=total.device)
            self.failures += (~torch.isfinite(total)) | (dropped > 0)
        return batch, total, aux


def run_reference(cell, quant=identity, chunk: int = 16384, program=None,
                  keep: bool = False) -> Dict:
    """The reference's readings over the cell's checked steps, held to
    ``program`` ({"params": after the steps, "colour": the first step's
    rendered colour}; default the program's own); ``keep``: also return
    the reference's. The keys of ``check.run_reference``'s; no occupancy
    update (its numbers NaN)."""
    m, dev, seed = cell.model_dict, cell.device, cell.seed
    ck = cell.checked
    program = program or {"params": ck["params"], "colour": ck["colour"]}
    ref = DenseReference(m, dev, quant)
    frustum = check.frustum_grid(cell.traffic["capture"], m, cell.scale, dev) \
        if m["use_view_frustum_culling"] else None
    bins = ref.binaries(frustum)
    params = weights.make(m, seed, dev)
    start = {k: v.clone() for k, v in params.items()}
    state: Dict = {}
    out = {"losses": [], "samples": [], "evaluated": [],
           "occupancy": float("nan"), "occupancy_flips": float("nan")}
    for k, batch in enumerate(ck["batches"]):
        step = ck["start_step"] + k
        loss, grads, n_valid, n_dropped, colour = ref.step(
            params, state, batch, bins, step, trainer_seed(seed),
            step_lrs(cell.optimizers, step), chunk)
        out["losses"].append(loss)
        out["samples"].append(n_valid)
        out["evaluated"].append(n_valid - n_dropped)
        if k == 0:
            seen = program["colour"].to(dev)
            out["render"] = check._norm(seen - colour) / max(check._norm(1.0 - colour), 1e-30) \
                if seen.shape == colour.shape else 1.0
            out["grad_norms"] = {n: None if g is None else check._norm(g)
                                 for n, g in grads.items()}
            if keep:
                out["colour"] = colour.cpu()
        del grads
    with torch.no_grad():
        out["change_norms"] = {k: check._norm(params[k] - start[k]) for k in params}
        out["program_change_norms"] = {k: check._norm(program["params"][k].to(dev) - start[k])
                                       for k in params}
    if keep:
        out["params"] = {k: v.detach().cpu() for k, v in params.items()}
    del params, start, state
    return out


def numbers(cell, ref: Dict) -> Dict[str, float]:
    """``check.numbers`` without ``occupancy``."""
    out = check.numbers(cell, ref)
    del out["occupancy"]
    return out


def spans_segment(cell, steps: int) -> Dict:
    """``steps`` steps with the port's tracer on (``utils/spans.py``): its
    counters and spans over them."""
    from nersemble_tpu_torch.utils import spans

    spans.reset()
    spans.enable(cell.device)
    counted = spans.counters()
    try:
        for _ in range(steps):
            cell.one_step()
        cell.sync()
        traced = spans.export()
    finally:
        spans.disable()
    counters = {k: v - counted.get(k, 0.0) for k, v in traced["counters"].items()}
    log(f"{steps} traced steps' counters: " + json.dumps(
        {k: v for k, v in counters.items() if k.startswith(("samples_", "field_"))}))
    return {"counters": counters, "spans": traced["spans"]}


def run(ctx) -> Dict:
    """One run of a dense training cell (``ctx``: ``run.RunContext``):
    set-up, the window (with the layer timers when traced), then when
    traced the tracer's steps and the profiled segment, then the check."""
    from benchmark import profile, trace
    from benchmark.reference.nersemble_ref import grid_layout

    cell = DenseTrainCell(ctx.config, ctx.traffic, ctx.seed, ctx.device,
                          capture_root=ctx.capture_root)
    cell.setup()
    setup_peak = torch.cuda.max_memory_allocated(ctx.device) \
        if ctx.device.type == "cuda" else 0
    setup_s = time.perf_counter() - ctx.t_start
    if ctx.device.type == "cuda":
        log(f"held before the window: {torch.cuda.memory_allocated(ctx.device) / 2**30:.3f} "
            f"GiB; set-up's peak {setup_peak / 2**30:.3f} GiB")
    timers, evaluated = None, []
    if ctx.trace:
        timers = trace.LayerTimers(ctx.device, grid_layout(cell.model_dict))
        timers.install()
    cell.failures = torch.zeros((), dtype=torch.int64, device=ctx.device)
    try:
        win = cell.window(ctx.seconds, per_step=(lambda aux: evaluated.append(
            aux["num_samples"] - aux["num_budget_dropped"])) if ctx.trace else None)
    finally:
        if timers is not None:
            timers.uninstall()
    failed = int(cell.failures)
    cell.failures = None
    log(f"window: {failed} steps failed (a loss not finite, or valid samples dropped)")
    result = {"metrics": {
        "train_rays_per_s": win["rays"] / win["seconds"],
        "train_peak_gib": win["peak_bytes"] / 2 ** 30,
        "setup_s": setup_s,
    }, "attempted": win["steps"], "failed": failed,
        "peak_bytes": max(win["peak_bytes"], setup_peak)}
    if ctx.trace:
        layers = timers.totals()
        program = spans_segment(cell, ctx.traffic["spans_steps"])

        def steps():
            for _ in range(ctx.traffic["profile_steps"]):
                with torch.profiler.record_function(profile.STEP_RANGE):
                    cell.one_step()
            cell.sync()
        result["trace"] = {
            "steps": win["steps"], "window_s": win["seconds"], "layers": layers,
            "batch_wait_s": list(cell.batch_wait_s[:win["steps"]]),
            "evaluated_samples": float(sum(float(e) for e in evaluated)),
            "model": cell.model_dict, **program,
            "profile": profile.record(steps, ctx.device)}
    cell.close()
    ref = run_reference(cell)
    result["numbers"] = numbers(cell, ref)
    log(f"check done: {result['numbers']}")
    return result
