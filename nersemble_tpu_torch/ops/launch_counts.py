"""The port's hand kernels' launch counters, one per kernel name, reset and
read together (chip_smoke.py, ``parallel/compare.py``,
``scripts/trained_scene.py`` and the tracer, ``utils/spans.py``, show with
them that a path went through the kernels). Each wrapper calls ``add`` once
per op call, where it launches its kernel. This module imports no other
module of the port, so every wrapper and the tracer can import it."""

import collections
from typing import Dict

KERNELS = ("fused_mlp_fwd", "fused_mlp_bwd", "quad_build", "quad_fold",
           "blended_encode_fwd", "blended_encode_bwd", "fused_adam", "time_code_bwd")
# of those, the launches on narrow rows: B3/B4 on rows or quarters of 2 to 8
# bytes (the single grid and its columns), A3 on quad rows of 4 elements (the
# single grid's column of one feature)
NARROW = ("quad_build narrow", "quad_fold narrow", "blended_encode_fwd narrow",
          "blended_encode_bwd narrow")
# the kernels a forward pass alone (a render) launches
FORWARD = ("fused_mlp_fwd", "quad_build", "blended_encode_fwd")
# the measurement path's copy kernels P1-P4 (ops/copy_kernels.py)
COPIES = ("gather_rows", "copy", "bcast_quarters", "fetch7")

_COUNTS = collections.Counter()


def add(kernel: str, n: int = 1) -> None:
    _COUNTS[kernel] += n


def reset() -> None:
    _COUNTS.clear()


def read(kernels=KERNELS) -> Dict[str, int]:
    return {name: _COUNTS[name] for name in kernels}
