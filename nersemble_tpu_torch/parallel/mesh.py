"""The ranks of a run over torch.distributed: data parallelism over rays
(port of nersemble_tpu/parallel/mesh.py).

The JAX package shards the ray batch over a ``data`` mesh axis and lets
GSPMD insert the collectives; here one process drives one card and the
collectives are explicit. ``DataMesh`` is that axis: the process group, the
rank's contiguous slice of the ray axis (the rows ``P("data")`` gives device
r) and four collectives on the ray and entry axes: sum all-reduce, row
all-gather, row reduce-scatter and broadcast, plus autograd versions of the
row all-gather and reduce-scatter (each the other's backward).

``DataMesh()`` without a group is one rank: every collective returns its
input. The backend is the caller's choice (``init``) and nothing changes it:
NCCL with one card per rank, gloo with CPU tensors in the tests. gloo takes
no CUDA tensors for these calls, so a gloo group on the card stages each
call through page-locked host copies (it waits for the device there), and
it runs reduce-scatter as an all-reduce and a slice, which every gloo build
supports. Host objects (a run's name, the viewer's requests) go over a
host group, gloo over CPU memory (the world group itself when it is gloo),
so sharing them never touches a card.
"""

import datetime
import functools
import os
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from nersemble_tpu_torch.utils import spans


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def axis_size(data_axis_size: int, device) -> int:
    """Ranks of the data axis: ``-1`` is every visible card (one on the
    CPU), any other value is taken as it is."""
    if data_axis_size != -1:
        if data_axis_size < 1:
            raise ValueError(f"data_axis_size={data_axis_size}: -1 or >= 1")
        return data_axis_size
    if torch.device(device).type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return 1


def _all_gather_tensor(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter_tensor(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, x, group=group)


def _collective(method):
    """Counts the call and its host seconds (the counters ``comm_calls`` and
    ``comm_s``, ``utils/spans.py``): the whole collective on gloo, which
    waits for it; the enqueue on NCCL, whose device time a profile shows as
    its ``nccl`` kernels."""
    @functools.wraps(method)
    def wrapper(self, x, *args, **kwargs):
        if self.group is None:
            return x
        start = time.perf_counter()
        out = method(self, x, *args, **kwargs)
        spans.count("comm_calls")
        spans.count("comm_s", time.perf_counter() - start)
        return out
    return wrapper


class DataMesh:
    """One data-parallel axis of ``size`` ranks (``size`` 1 without a
    group)."""

    def __init__(self, group=None, backend: Optional[str] = None, host_group=None):
        self.group = group
        self.backend = backend
        # gloo over CPU memory: host objects, never a card
        self.host_group = host_group if host_group is not None \
            else (group if backend == "gloo" else None)
        self.size = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0

    def __repr__(self) -> str:
        return f"DataMesh(rank {self.rank} of {self.size}, {self.backend})"

    # -- the ray axis ---------------------------------------------------------

    def rows(self, n: int) -> slice:
        """This rank's contiguous slice of ``n`` rows (``n`` divides)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    # -- collectives ------------------------------------------------------------

    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.is_cuda

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host

    @_collective
    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, as a new tensor."""
        if self._staged(x):
            host = self._host(x)
            dist.all_reduce(host, group=self.group)
            return host.to(x.device, non_blocking=True)
        out = x.clone()
        dist.all_reduce(out, group=self.group)
        return out

    @_collective
    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """[m, ...] per rank -> [size * m, ...], rank-major."""
        x = x.contiguous()
        if self.backend == "gloo":
            src = self._host(x) if x.is_cuda else x
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src, group=self.group)
            return torch.cat(parts).to(x.device, non_blocking=True)
        out = torch.empty((self.size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        _all_gather_tensor(out, x, self.group)
        return out

    @_collective
    def reduce_scatter_rows(self, x: torch.Tensor) -> torch.Tensor:
        """[size * m, ...] per rank -> this rank's [m, ...] of the sum."""
        rows = self.rows(x.shape[0])
        if self.backend == "gloo":
            if self._staged(x):
                host = self._host(x)
                dist.all_reduce(host, group=self.group)
                return host[rows].to(x.device, non_blocking=True)
            out = x.clone()
            dist.all_reduce(out, group=self.group)
            return out[rows].contiguous()
        out = torch.empty((x.shape[0] // self.size, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        _reduce_scatter_tensor(out, x.contiguous(), self.group)
        return out

    @_collective
    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, in place."""
        if self._staged(x):
            host = self._host(x)
            dist.broadcast(host, src, group=self.group)
            x.copy_(host)
            return x
        dist.broadcast(x, src, group=self.group)
        return x

    def broadcast_object(self, obj, src: int = 0):
        """A picklable host object of rank ``src`` on every rank (over the
        host group)."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src, group=self.host_group)
        return box[0]

    def share_items(self, items: Optional[List], src: int = 0) -> List:
        """Rank ``src``'s list of picklable host objects on every rank (the
        others pass None): one broadcast of its length over the host group
        and, unless it is empty, one of the items. No device work and no
        read of a tensor's value, so an empty list costs one small host
        message (the viewer's steps without a request)."""
        if self.group is None:
            return list(items)
        count = np.array([len(items) if self.rank == src else 0], np.int64)
        dist.broadcast(torch.from_numpy(count), src, group=self.host_group)
        if count[0] == 0:
            return []
        return self.broadcast_object(items if self.rank == src else None, src)

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    # -- autograd -----------------------------------------------------------------

    def all_gather_rows_grad(self, x: torch.Tensor) -> torch.Tensor:
        """``all_gather_rows`` whose backward reduce-scatters the gradient."""
        if self.group is None:
            return x
        return _AllGatherRows.apply(x, self)

    def reduce_scatter_rows_grad(self, x: torch.Tensor) -> torch.Tensor:
        """``reduce_scatter_rows`` whose backward all-gathers the gradient."""
        if self.group is None:
            return x
        return _ReduceScatterRows.apply(x, self)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_gather_rows(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.reduce_scatter_rows(grad), None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.reduce_scatter_rows(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_gather_rows(grad), None


def init(backend: str, device, rank: Optional[int] = None,
         world_size: Optional[int] = None, store=None,
         timeout_s: float = 1800.0) -> DataMesh:
    """Join the process group and return its mesh. With ``rank`` None the
    rank, world size and local rank come from torchrun's ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` (``env://``); else from the arguments
    and ``store`` (a ``torch.distributed`` store, e.g. a ``FileStore``). On
    a CUDA device each rank takes card ``LOCAL_RANK`` (or ``rank``) modulo
    the visible cards: gloo ranks may share one, NCCL ranks may not."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    device = torch.device(device)
    local_rank = rank
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        local_rank %= torch.cuda.device_count()
        torch.cuda.set_device(local_rank)
    kwargs = {"timeout": datetime.timedelta(seconds=timeout_s)}
    if store is not None:
        kwargs.update(store=store, rank=rank, world_size=world_size)
    else:
        kwargs.update(init_method="env://", rank=rank, world_size=world_size)
    dist.init_process_group(backend, **kwargs)
    host_group = None if backend == "gloo" else dist.new_group(
        backend="gloo", timeout=kwargs["timeout"])
    mesh = DataMesh(dist.group.WORLD, backend, host_group)
    where = f"cuda:{local_rank}" if device.type == "cuda" else "cpu"
    print(f"[nersemble-torch] rank {mesh.rank} of {mesh.size}: {backend} "
          f"process group on {where}", flush=True)
    return mesh


def local_device(device, mesh: DataMesh) -> torch.device:
    """The rank's own device: ``cuda:<current card>`` for a CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and mesh.group is not None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
