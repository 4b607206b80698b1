"""Start the ranks of a data-parallel run.

``torchrun --nproc-per-node N -m <module> ...`` starts the N processes
itself and names their rank in the environment (``under_torchrun``);
otherwise ``spawn(fn, n, ...)`` starts n processes here with
``torch.multiprocessing.spawn``, one card each on the GPU, joined by a
``FileStore`` in a temporary directory (no port to pick). gloo ranks may
share a card (rank r takes card r mod the visible count); NCCL refuses
that. Each process
joins the group (``mesh.init``), runs ``fn(mesh, *args)`` and leaves it;
``spawn`` returns rank 0's result, which must be JSON. ``run_cli`` runs a
CLI's ``run(argv, mesh, *extra)`` (train, evaluate, render, view) on the
ranks of its run's ``data_axis_size``: under torchrun, spawned here, or in
this process.
"""

import importlib
import json
import os
import shutil
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from nersemble_tpu_torch import env
from nersemble_tpu_torch.parallel import mesh as mesh_lib

# the path roots the ranks take from the process that starts them (a caller
# may have repointed the env module's attributes)
ENV_ROOTS = ("NERSEMBLE_DATA_PATH", "NERSEMBLE_MODELS_PATH", "NERSEMBLE_RENDERS_PATH")


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _rank_main(rank: int, fn, n: int, backend: str, device: str,
               store_dir: str, timeout_s: float, args: tuple) -> None:
    if torch.device(device).type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(1)
    store = dist.FileStore(str(Path(store_dir) / "store"), n)
    mesh = mesh_lib.init(backend, device, rank=rank, world_size=n, store=store,
                         timeout_s=timeout_s)
    try:
        result = fn(mesh, *args)
        if rank == 0:
            (Path(store_dir) / "result.json").write_text(json.dumps(result))
    finally:
        mesh_lib.shutdown()


def spawn(fn, n: int, backend: str, device, *args, timeout_s: float = 1800.0):
    """Run ``fn(mesh, *args)`` on ``n`` new ranks; rank 0's result. A
    collective that waits longer than ``timeout_s`` (a rank that died)
    raises."""
    if (backend == "nccl" and torch.device(device).type == "cuda"
            and torch.cuda.device_count() < n):
        raise RuntimeError(f"{n} NCCL ranks need {n} cards, "
                           f"{torch.cuda.device_count()} are visible")
    store_dir = tempfile.mkdtemp(prefix="nersemble_ranks_")
    try:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, n, backend, str(device), store_dir, timeout_s,
                              args),
            nprocs=n, join=True)
        result = Path(store_dir) / "result.json"
        return json.loads(result.read_text()) if result.exists() else None
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def default_backend(device, n: int) -> str:
    """NCCL where each of the ``n`` ranks on this host has a card of its
    own, else gloo (the CPU, or ranks that share a card)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def _cli_rank(mesh, module: str, argv, roots, extra):
    for name, value in roots.items():
        setattr(env, name, value)
    return importlib.import_module(module).run(argv, mesh, *extra)


def run_cli(module: str, argv, device, data_axis_size: int, *extra,
            backend=None, timeout_s: float = 1800.0):
    """``module.run(argv, mesh, *extra)`` on the ranks of a run whose
    ``config.parallel.data_axis_size`` is ``data_axis_size`` (-1: every
    visible card, one rank on the CPU): under torchrun on its processes,
    else on that many ranks spawned here (each takes this process's
    ``ENV_ROOTS``), else in this process with no mesh. The ranks join by
    ``backend``, or by ``default_backend`` of this host's ranks. Returns
    rank 0's result (JSON from spawned ranks)."""
    if under_torchrun():
        local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        mesh = mesh_lib.init(backend or default_backend(device, local), device,
                             timeout_s=timeout_s)
        try:
            if data_axis_size not in (-1, mesh.size):
                raise ValueError(f"the run's data_axis_size {data_axis_size} under "
                                 f"torchrun's {mesh.size} processes")
            return importlib.import_module(module).run(argv, mesh, *extra)
        finally:
            mesh_lib.shutdown()
    n = mesh_lib.axis_size(data_axis_size, device)
    if n == 1:
        return importlib.import_module(module).run(argv, None, *extra)
    roots = {name: getattr(env, name) for name in ENV_ROOTS}
    return spawn(_cli_rank, n, backend or default_backend(device, n), device, module,
                 list(argv), roots, list(extra), timeout_s=timeout_s)
