"""The train path's hand kernels' launch counters, reset and read together
(chip_smoke.py, ``parallel/compare.py`` and ``scripts/trained_scene.py``
show with them that a path went through the kernels). Each wrapper adds
one to its counter where it launches its kernel."""

from typing import Dict

from nersemble_tpu_torch.ops import (fused_adam, fused_mlp, hash_encoding, quad_kernel,
                                     time_code)

# kernel name: (module, counter)
COUNTERS = {
    "fused_mlp_fwd": (fused_mlp, "LAUNCHES"),
    "fused_mlp_bwd": (fused_mlp, "BWD_LAUNCHES"),
    "quad_build": (quad_kernel, "LAUNCHES"),
    "quad_fold": (quad_kernel, "FOLD_LAUNCHES"),
    "blended_encode_fwd": (hash_encoding, "LAUNCHES"),
    "blended_encode_bwd": (hash_encoding, "BWD_LAUNCHES"),
    "fused_adam": (fused_adam, "LAUNCHES"),
    "time_code_bwd": (time_code, "LAUNCHES"),
    # of those, the launches on narrow rows: B3/B4 on rows or quarters of 2
    # to 8 bytes (the single grid and its columns), A3 on quad rows of 4
    # elements (the single grid's column of one feature)
    "quad_build narrow": (quad_kernel, "NARROW_LAUNCHES"),
    "quad_fold narrow": (quad_kernel, "NARROW_FOLD_LAUNCHES"),
    "blended_encode_fwd narrow": (hash_encoding, "NARROW_LAUNCHES"),
    "blended_encode_bwd narrow": (hash_encoding, "NARROW_BWD_LAUNCHES"),
}
KERNELS = ("fused_mlp_fwd", "fused_mlp_bwd", "quad_build", "quad_fold",
           "blended_encode_fwd", "blended_encode_bwd", "fused_adam", "time_code_bwd")
NARROW = ("quad_build narrow", "quad_fold narrow", "blended_encode_fwd narrow",
          "blended_encode_bwd narrow")
# the kernels a forward pass alone (a render) launches
FORWARD = ("fused_mlp_fwd", "quad_build", "blended_encode_fwd")


def reset() -> None:
    for module, counter in COUNTERS.values():
        setattr(module, counter, 0)


def read(kernels=KERNELS) -> Dict[str, int]:
    return {name: getattr(*COUNTERS[name]) for name in kernels}
