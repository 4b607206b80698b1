"""Small constant tensors kept on the device."""

import functools
from typing import Tuple

import torch


@functools.lru_cache(maxsize=64)
def device_constant(values: Tuple[float, ...], dtype: torch.dtype,
                    device) -> torch.Tensor:
    """A small constant tensor, copied to ``device`` once. Creating it per
    call would be a pageable host-to-device copy, which synchronizes the
    stream and drains the GPU's queue of kernels. Callers must not write
    to it (every caller shares it)."""
    return torch.tensor(values, dtype=dtype, device=device)
