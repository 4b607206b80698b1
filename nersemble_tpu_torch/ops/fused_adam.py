"""One Adam step over every leaf: the CUDA kernel ``csrc/fused_adam.cu`` and
its plain PyTorch version.

The JAX package's Adam (nersemble_tpu/engine/optimizers.py
``fused_adam_update``) is elementwise XLA; this module is the optimizer's
hand kernel beside it (see the note at the top of the source).
``adam_update`` is the entry point: on CPU tensors it runs
``adam_update_plain`` leaf by leaf, on CUDA tensors ``adam_update_cuda``,
which launches the kernel over every leaf at once or raises. The kernel
gives the plain version's bits.

A leaf is ``(p, g, mu, nu, lr)``: the parameter (or the rows of it being
stepped), its gradient, both moments and the leaf's learning rate.
"""

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch
from torch.autograd.graph import increment_version

from nersemble_tpu_torch.ops import cuda_lib

LAUNCHES = 0  # kernel launches since the last reset (ops/launch_counts.py)
MAX_SEGMENTS = 64  # csrc/fused_adam.cu ADAM_MAX_SEGS: one launch's segments
VECTOR_BYTES = 16  # the kernel's float4 loads and stores
# the kernel's segment kinds: the gradient's type, VECTOR on a float4 body
G_KINDS = {torch.float32: 0, torch.bfloat16: 1}
VECTOR = 2


class Segment(NamedTuple):
    """A run of one leaf's elements that one kind of tile walks: element
    ``start`` on, ``count`` elements, as float4s (``vector``) or one by
    one."""
    leaf: int
    start: int
    count: int
    vector: bool


def plan_segments(leaves: Sequence[Tuple[int, int, int, int, int, int]]) -> List[Segment]:
    """Cut each leaf ``(p, g, mu, nu, numel, g_bytes)`` (the four data
    addresses, the element count and the gradient's element size; p, mu and
    nu are f32) into the kernel's segments, covering every element once: a
    scalar head up to p's first 16-byte boundary, a vector body of whole
    float4s and a scalar tail. The body needs mu, nu and the gradient
    aligned at the same element as p (the gradient to 4 of its elements);
    a leaf where they are not is one scalar segment."""
    segments = []
    for i, (p, g, mu, nu, numel, g_bytes) in enumerate(leaves):
        if numel == 0:
            continue
        head = min(numel, (-p % VECTOR_BYTES) // 4)
        body = (numel - head) // 4 * 4
        aligned = all((addr + 4 * head) % VECTOR_BYTES == 0 for addr in (mu, nu)) \
            and (g + g_bytes * head) % (4 * g_bytes) == 0
        if not aligned or body == 0:
            segments.append(Segment(i, 0, numel, False))
            continue
        if head:
            segments.append(Segment(i, 0, head, False))
        segments.append(Segment(i, head, body, True))
        if head + body < numel:
            segments.append(Segment(i, head + body, numel - head - body, False))
    return segments


def adam_update_plain(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                      nu: torch.Tensor, lr: float, c1: torch.Tensor, c2: torch.Tensor,
                      b1: float, b2: float, eps: float) -> None:
    """One leaf's step in place, op by op (the formula of
    ``engine/optimizers.py``); the gradient is widened to f32 first."""
    g = g.to(torch.float32)
    mu.copy_(b1 * mu + (1.0 - b1) * g)
    nu.copy_(b2 * nu + (1.0 - b2) * torch.square(g))
    update = (mu / c1) / (torch.sqrt(nu / c2) + eps)
    p.sub_(lr * update.to(p.dtype))


class _Segment(ctypes.Structure):  # csrc/fused_adam.cu AdamSeg
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("mu", ctypes.c_void_p), ("nu", ctypes.c_void_p),
                ("count", ctypes.c_longlong), ("lr", ctypes.c_float),
                ("kind", ctypes.c_int)]


def _check_leaf(p, g, mu, nu, index: int) -> None:
    """Raise unless the kernel takes the leaf: contiguous tensors of one
    shape on card ``index``, f32 but for an f32 or bf16 gradient."""
    tensors = (p, g, mu, nu)
    if all(t.get_device() == index and t.is_contiguous() for t in tensors) \
            and p.dtype == mu.dtype == nu.dtype == torch.float32 \
            and g.dtype in G_KINDS and p.shape == g.shape == mu.shape == nu.shape:
        return
    for what, t in zip(("parameter", "gradient", "mu", "nu"), tensors):
        if t.get_device() != index:
            raise ValueError(f"the Adam kernel takes every tensor on cuda:{index}; "
                             f"a {what} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"the Adam kernel takes contiguous tensors; a {what} "
                             f"of shape {tuple(t.shape)} is not")
        if t is not g and t.dtype != torch.float32:
            raise ValueError(f"the Adam kernel takes an f32 {what}, not {t.dtype}")
    if g.dtype not in G_KINDS:
        raise ValueError(f"the Adam kernel takes f32 or bf16 gradients, not {g.dtype}")
    raise ValueError(f"Adam leaf shapes differ: {tuple(p.shape)}, {tuple(g.shape)}, "
                     f"{tuple(mu.shape)}, {tuple(nu.shape)}")


def adam_update_cuda(leaves, c1: torch.Tensor, c2: torch.Tensor, b1: float,
                     b2: float, eps: float) -> None:
    """Launch the kernel over ``leaves`` (contiguous CUDA tensors, f32 but
    for the gradient) in place: one launch per ``MAX_SEGMENTS`` segments.
    ``c1``, ``c2``: the bias corrections, f32 scalars on the same card."""
    global LAUNCHES
    device = c1.device
    if device.type != "cuda" or c2.device != device:
        raise ValueError("adam_update_cuda takes CUDA tensors")
    if c1.dtype != torch.float32 or c2.dtype != torch.float32:
        raise ValueError("the bias corrections must be f32")
    addresses = []
    for p, g, mu, nu, _ in leaves:
        _check_leaf(p, g, mu, nu, device.index)
        addresses.append((p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                          p.numel(), g.element_size()))
    plan = plan_segments(addresses)
    if not plan:
        return
    rows = []
    for seg in plan:
        p, g, mu, nu, _, g_bytes = addresses[seg.leaf]
        kind = G_KINDS[leaves[seg.leaf][1].dtype] | (VECTOR if seg.vector else 0)
        rows.append((p + 4 * seg.start, g + g_bytes * seg.start, mu + 4 * seg.start,
                     nu + 4 * seg.start, seg.count, leaves[seg.leaf][4], kind))
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    for first in range(0, len(rows), MAX_SEGMENTS):
        part = rows[first:first + MAX_SEGMENTS]
        status = lib.fused_adam((_Segment * len(part))(*part), len(part), c1.data_ptr(),
                                c2.data_ptr(), b1, b2, 1.0 - b1, 1.0 - b2, eps, stream)
        cuda_lib.check(status, "fused_adam")
        LAUNCHES += 1
    # the kernel wrote through pointers: bump the version counters, as an
    # in-place op would, so caches keyed by them (the fused MLPs' packed
    # weights, the renderer's quad table) see the new values
    for p, _, mu, nu, _ in leaves:
        for t in (p, mu, nu):
            increment_version(t)


def adam_update(leaves, c1: torch.Tensor, c2: torch.Tensor, b1: float, b2: float,
                eps: float) -> None:
    """One Adam step of every leaf ``(p, g, mu, nu, lr)`` in place: the
    kernel on CUDA, the plain version on the CPU. ``1 - b1``, ``1 - b2``
    are taken in double, then rounded to f32, in both."""
    if c1.device.type == "cpu":
        for p, g, mu, nu, lr in leaves:
            adam_update_plain(p, g, mu, nu, lr, c1, c2, b1, b2, eps)
    else:
        adam_update_cuda(leaves, c1, c2, b1, b2, eps)
