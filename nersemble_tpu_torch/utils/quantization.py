"""The depth codec of the compressed dataset assets (the port's numpy copy of
``Quantizer`` and ``DepthQuantizer`` in nersemble_tpu/utils/quantization.py).

The dataset ships depth maps as 16-bit PNGs quantizing metric depth in
[0, 2] m, with bin 0 reserved as an invalid-pixel mask
(reference: src/nersemble/util/quantization.py:31-117).
"""

from typing import Union

import numpy as np


class Quantizer:
    """Uniform scalar quantizer with an optional reserved mask bin 0."""

    def __init__(self,
                 min_values: Union[np.ndarray, float],
                 max_values: Union[np.ndarray, float],
                 bits: int,
                 mask_value: float = 0,
                 separate_mask: bool = True):
        self._min_values = min_values
        self._max_values = max_values
        self._bits = bits
        self._mask_value = mask_value
        self._mask_offset = 1 if separate_mask else 0
        self._n_buckets = 2 ** bits
        self._scale_factor = (self._n_buckets - 1 - self._mask_offset) / (max_values - min_values)

    def encode(self, values: np.ndarray) -> np.ndarray:
        mask = values != self._mask_value
        if mask.ndim > 2:
            mask = mask.any(axis=-1)
        scaled = np.maximum(0, values - self._min_values) * self._scale_factor + self._mask_offset
        scaled = np.asarray(scaled, dtype=np.float64)
        scaled[~mask] = 0
        return scaled.round().astype(np.uint8 if self._bits == 8 else np.uint16)

    def decode(self, quantized: np.ndarray) -> np.ndarray:
        mask = quantized == self._mask_value
        if mask.ndim > 2:
            mask = mask.all(axis=-1)
        values = (quantized.astype(np.float32) - self._mask_offset) / self._scale_factor + self._min_values
        values[mask] = self._mask_value
        return values


class DepthQuantizer(Quantizer):
    """16-bit depth codec over [0, 2] m; values > 2 m are masked as outliers."""

    def __init__(self, min_values: float = 0, max_values: float = 2,
                 bits: int = 16, separate_mask: bool = True):
        super().__init__(min_values=min_values, max_values=max_values,
                         bits=bits, separate_mask=separate_mask)

    def encode(self, values: np.ndarray) -> np.ndarray:
        values = np.array(values, copy=True)
        values[values > self._max_values] = self._mask_value
        return super().encode(values)
