"""Start the ranks of a data-parallel run.

``torchrun --nproc-per-node N -m <module> ...`` starts the N processes
itself and names their rank in the environment (``under_torchrun``);
otherwise ``spawn(fn, n, ...)`` starts n processes here with
``torch.multiprocessing.spawn``, one card each on the GPU, joined by a
``FileStore`` in a temporary directory (no port to pick). gloo ranks may
share a card (rank r takes card r mod the visible count); NCCL refuses
that. Each process
joins the group (``mesh.init``), runs ``fn(mesh, *args)`` and leaves it;
``spawn`` returns rank 0's result, which must be JSON.
"""

import json
import os
import shutil
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from nersemble_tpu_torch.parallel import mesh as mesh_lib


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
