"""The same training steps on one rank and on several: the equality check of
the multi-device layouts (the port's counterpart of
tests/test_table_sharding.py and the JAX trainer's multi-device tests).

``run_steps(mesh, spec)`` runs on every rank of a mesh (``launch.spawn``)
or on one process (``mesh`` None): it builds a ``NeRSembleTrainer`` from
the whole parameters of ``spec``, takes each rank's rows of every batch,
trains, checks that the ranks' replicated parameters and grids are bitwise
equal, and has rank 0 write the whole state as a checkpoint (the JAX npz
format) to ``spec["out"]``. ``max_violation`` holds two such checkpoints
(``engine.checkpoints.read_flat``) to a tolerance. chip_smoke.py uses it
on the card, the tests on the CPU.
"""

import hashlib
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from nersemble_tpu_torch.config import ParallelConfig

SEED = 0
LAYOUTS = {
    "replicated": ParallelConfig(shard_table_params=False,
                                 shard_table_optimizer=False),
    "zero3": ParallelConfig(),
    "moments": ParallelConfig(shard_table_params=False),
    "tp": ParallelConfig(shard_hash_tables=True, shard_table_params=False,
                         shard_table_optimizer=False),
}


def synthetic_batches(n_rays: int, n_steps: int, n_timesteps: int,
                      seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """Rays from x = -8 toward the scene box with random supervision, one
    batch per step (the JAX tests' ``_example_rays`` and batch)."""
    batches = []
    for step in range(n_steps):
        rng = np.random.default_rng([seed, step])
        d = rng.normal(size=(n_rays, 3)) * [0.05, 0.3, 0.3] + [1.0, 0.0, 0.0]
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        batches.append({
            "origins": np.tile(np.float32([[-8.0, 0.0, 0.0]]), (n_rays, 1)),
            "directions": d.astype(np.float32),
            "timesteps": rng.integers(0, n_timesteps, n_rays).astype(np.int64),
            "rgb": rng.uniform(size=(n_rays, 3)).astype(np.float32),
            "alpha": rng.uniform(size=n_rays).astype(np.float32),
            "depth": rng.uniform(7.5, 9.5, n_rays).astype(np.float32),
        })
    return batches


def replicas_equal(mesh, tensors) -> bool:
    """Whether every rank holds bitwise the same ``tensors``."""
    if mesh is None or mesh.size == 1:
        return True
    same = True
    for t in tensors:
        rows = mesh.all_gather_rows(t.detach().reshape(1, -1))
        same &= bool((rows == rows[:1]).all())
    return same


def run_steps(mesh, spec: Dict) -> Dict:
    """Train the steps of ``spec`` on this rank. ``spec``: ``config`` (a
    ModelConfig), ``layout`` (a key of LAYOUTS), ``params`` (the whole
    parameters as numpy trees; None: the seeded draw of ``SEED``, alike on
    every rank), ``contrast`` (scale them by ``utils.cameras.add_contrast``,
    so that the table, the time codes and the warp shape the output),
    ``grid_occs``, ``batches`` (whole batches),
    optional ``jitters`` (one per step, whole batch: the step then runs
    ``train_step`` alone, as the JAX tests' step does; else ``run_step``
    with the occupancy update and the adaptive budget), ``sched`` and
    ``lrs`` (constant; default the schedules), ``budget``, ``n_rays``
    (default the batches'), ``load`` (a checkpoint to resume from: its
    parameters, moments, grid and budget replace the others, and the steps
    go on from its step; else they start at ``first_step``, default 0),
    ``device``, ``out`` (the checkpoint rank 0
    writes at the last step; with no batches, of the loaded state) and
    ``params_out`` (the whole parameters alone, an npz of ``params.a.b.c``
    keys), ``first_mu_out`` (the first moments after the first step, 0.1
    times its gradient, as ``mu.a.b.c``) and ``digest`` (return SHA-256
    digests of the parameters, both Adam moments and the occupancy grid).
    Returns the logged values, the table layout, the kernels' launches in
    the steps, ms per step (host clock, synchronised), the collectives'
    host ms in each step, whether the ranks' replicas agree, whether JAX was
    imported and, on the card, every rank's peak memory (GiB)."""
    from nersemble_tpu_torch.engine.checkpoints import params_from_numpy
    from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
    from nersemble_tpu_torch.models.nersemble import NeRSembleModel
    from nersemble_tpu_torch.ops import launch_counts
    from nersemble_tpu_torch.utils.cameras import add_contrast

    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda" and mesh is not None:
        device = torch.device("cuda", torch.cuda.current_device())
    batches = spec["batches"]
    n_rays = spec.get("n_rays") or batches[0]["origins"].shape[0]
    if spec["params"] is not None:
        params = params_from_numpy(spec["params"], device)
    else:  # the trainer's own draw, on the host: alike on every rank
        params = NeRSembleModel(spec["config"], "cpu").init_params(
            torch.Generator().manual_seed(SEED))
    if spec.get("contrast"):
        add_contrast(params)
    trainer = NeRSembleTrainer(
        spec["config"], n_rays=n_rays, device=device, seed=SEED,
        params=params.to(device),
        grid_occs=torch.from_numpy(np.asarray(spec["grid_occs"], np.float32)).to(device),
        mesh=mesh, parallel=LAYOUTS[spec["layout"]])
    if spec.get("sched") is not None:
        trainer.sched_values = lambda step: spec["sched"]
    if spec.get("lrs") is not None:
        trainer.lr_values = lambda step: spec["lrs"]
    if spec.get("budget") is not None:
        trainer._budget = spec["budget"]
    if spec.get("load"):
        trainer.load_checkpoint(spec["load"])
    else:
        trainer.start_step = spec.get("first_step", 0)
    rows = slice(None) if mesh is None else mesh.rows(n_rays)
    jitters = spec.get("jitters")
    launch_counts.reset()
    result = {"layout": trainer.table_layout, "loss": [], "losses": [],
              "num_samples": [], "num_budget_dropped": []}
    times, comm_ms = [], []
    for step, whole in enumerate(batches, start=trainer.start_step):
        batch = {k: torch.from_numpy(v[rows]).to(device) for k, v in whole.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        start = time.perf_counter()
        comm_s0 = 0.0 if mesh is None else mesh.comm_s
        if jitters is None:
            total, aux = trainer.run_step(step, batch)
        else:
            total, aux = trainer.train_step(step, batch,
                                            jitter=torch.from_numpy(
                                                jitters[step - trainer.start_step]))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - start)
        comm_ms.append(0.0 if mesh is None else 1e3 * (mesh.comm_s - comm_s0))
        result["loss"].append(float(total))
        result["losses"].append({k: float(v) for k, v in aux["losses"].items()})
        result["num_samples"].append(float(aux["num_samples"]))
        result["num_budget_dropped"].append(float(aux["num_budget_dropped"]))
        if step == trainer.start_step and spec.get("first_mu_out"):
            _save(trainer, spec["first_mu_out"], ("mu",))
    last = trainer.start_step + len(batches) - 1  # the last step trained
    result["launches"] = launch_counts.read()
    result["ms_per_step"] = [1e3 * t for t in times]
    result["comm_ms_per_step"] = comm_ms
    replicated = [p for k, p in trainer.params.named_parameters()
                  if trainer.table_layout == "replicated" or k != "field.table"]
    result["replicas_equal"] = replicas_equal(mesh, replicated + [trainer.grid_occs])
    result["jax_imported"] = "jax" in sys.modules
    if device.type == "cuda":  # every rank's
        peak = torch.tensor([torch.cuda.max_memory_allocated(device) / 2 ** 30],
                            dtype=torch.float64, device=device)
        result["peak_gib"] = (peak if mesh is None
                              else mesh.all_gather_rows(peak)).tolist()
    if spec.get("out"):
        trainer.save_checkpoint(spec["out"], last)
    if spec.get("digest"):
        arrays = _arrays(trainer, ("params", "mu", "nu"))
        if trainer.is_chief:
            arrays["grid_occs"] = trainer.grid_occs.cpu().numpy()
        result["digest"] = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes())
                            .hexdigest() for k, v in arrays.items()}
    if spec.get("params_out"):
        _save(trainer, spec["params_out"], ("params",))
    return result


def _arrays(trainer, whats) -> Dict[str, np.ndarray]:
    """The whole trees ``whats`` as flat ``what.a.b.c`` arrays on rank 0
    (empty on the others; every rank calls)."""
    trees = trainer.host_trees(whats)
    if not trainer.is_chief:
        return {}
    return {".".join((what,) + k): v for what in whats for k, v in _leaves(trees[what])}


def _save(trainer, path, whats) -> None:
    arrays = _arrays(trainer, whats)
    if trainer.is_chief:
        np.savez(path, **arrays)


def _leaves(tree, path=()):
    """(key path, array) of a numpy tree of dicts and lists."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, path + (str(i),))
    else:
        yield path, tree


def max_violation(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
                  atol: float, rtol: float,
                  prefixes=("params/", "opt_state/", "grid_occs")) -> Dict[str, float]:
    """Per float entry of two checkpoints' arrays under ``prefixes``: the
    largest ``|a - b| / (atol + rtol |b|)`` (at most 1 within tolerance)."""
    out = {}
    for key in a:
        if not key.startswith(prefixes) or a[key].dtype.kind != "f":
            continue
        x, y = np.asarray(a[key], np.float64), np.asarray(b[key], np.float64)
        if x.shape != y.shape:
            out[key] = float("inf")
            continue
        out[key] = float((np.abs(x - y) / (atol + rtol * np.abs(y))).max()) \
            if x.size else 0.0
    return out


def kept_mask(mesh, spec: Dict) -> Dict:
    """The kept sample mask [R, S] of the whole first batch of ``spec``
    (``run_steps``' keys; ``train`` picks the training forward, with the
    first jitter, or the eval forward) after the budget's compaction, each
    rank's rows all-gathered, with the whole batch's budget-dropped count."""
    from nersemble_tpu_torch.engine.checkpoints import params_from_numpy
    from nersemble_tpu_torch.models.nersemble import NeRSembleModel

    device = torch.device("cpu")
    model = NeRSembleModel(spec["config"], device)
    params = params_from_numpy(spec["params"], device)
    whole = spec["batches"][0]
    rows = slice(None) if mesh is None else mesh.rows(whole["origins"].shape[0])
    batch = {k: torch.from_numpy(v[rows]) for k, v in whole.items()}
    grid = torch.from_numpy(np.asarray(spec["grid_occs"], np.float32))
    jitter = torch.from_numpy(spec["jitters"][0][rows]) if spec["train"] else None
    out = model.render_rays(params, batch, model.binaries(grid), spec["sched"],
                            train=spec["train"], budget=spec["budget"],
                            jitter=jitter, mesh=mesh)
    kept = out["samples"].mask.to(torch.uint8)
    dropped = torch.as_tensor(out["num_budget_dropped"], dtype=torch.int64)
    if mesh is not None:
        kept, dropped = mesh.all_gather_rows(kept), mesh.all_reduce_sum(dropped)
    return {"kept": kept.tolist(), "dropped": int(dropped)}


def render(mesh, spec: Dict) -> Dict:
    """Render ``spec["frame"]`` (``Renderer.render_image``'s image rays) at
    ``step``, ``chunk`` and each of ``budgets`` through the renderer of a
    trainer in ``spec``'s layout; rank 0 writes the frames to
    ``spec["out"]`` as ``<budget>/<channel>`` arrays. Returns the probed
    auto budget."""
    from nersemble_tpu_torch.engine.checkpoints import params_from_numpy
    from nersemble_tpu_torch.engine.renderer import Renderer
    from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer

    device = torch.device("cpu")
    trainer = NeRSembleTrainer(
        spec["config"], n_rays=64, device=device,
        params=None if spec["params"] is None
        else params_from_numpy(spec["params"], device),
        grid_occs=torch.from_numpy(np.asarray(spec["grid_occs"], np.float32)),
        mesh=mesh, parallel=LAYOUTS[spec["layout"]], eval_only=True)
    renderer = Renderer(trainer.model, trainer.params, trainer.grid_occs,
                        mesh=mesh)
    frames = {}
    for budget in spec["budgets"]:
        image = renderer.render_image(spec["frame"], spec["step"],
                                      chunk=spec["chunk"], budget=budget)
        frames.update({f"{budget}/{k}": v for k, v in image.items()})
    if trainer.is_chief:
        np.savez(spec["out"], **frames)
    return {"layout": trainer.table_layout, "auto_budget": renderer.auto_budget}


def run_many(mesh, jobs: List[tuple]) -> List[Dict]:
    """``[(name, spec), ...]`` of ``run_steps`` / ``kept_mask`` / ``render``
    in one set of ranks (one start-up for several comparisons)."""
    fns = {"run_steps": run_steps, "kept_mask": kept_mask, "render": render}
    return [fns[name](mesh, spec) for name, spec in jobs]
