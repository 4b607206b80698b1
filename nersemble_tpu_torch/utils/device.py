"""The device an entry point runs on, and small constant tensors kept on
the device."""

import functools
from typing import Tuple

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``. The port's entry points run on the
    card unless the caller asks for another device; naming a CUDA device on
    a machine without one raises instead of carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU by "
                           "default; pass device='cpu' for its CPU path")
    return device


def to_device(array, device: torch.device) -> torch.Tensor:
    """A host array or tensor on ``device``. Host data reaches a GPU by a
    non-blocking copy from page-locked memory: a copy from pageable memory
    would wait for the GPU's queue to drain."""
    t = torch.as_tensor(array)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@functools.lru_cache(maxsize=64)
def device_constant(values: Tuple[float, ...], dtype: torch.dtype,
                    device) -> torch.Tensor:
    """A small constant tensor, copied to ``device`` once. Creating it per
    call would be a pageable host-to-device copy, which synchronizes the
    stream and drains the GPU's queue of kernels. Callers must not write
    to it (every caller shares it)."""
    return torch.tensor(values, dtype=dtype, device=device)
