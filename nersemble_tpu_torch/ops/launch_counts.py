"""The train path's hand kernels' launch counters, reset and read together
(chip_smoke.py, ``parallel/compare.py`` and ``scripts/trained_scene.py``
show with them that a path went through the kernels). Each wrapper adds
one to its counter where it launches its kernel."""

from typing import Dict

from nersemble_tpu_torch.ops import fused_mlp, hash_encoding, quad_kernel

# kernel name: (module, counter)
COUNTERS = {
    "fused_mlp_fwd": (fused_mlp, "LAUNCHES"),
    "fused_mlp_bwd": (fused_mlp, "BWD_LAUNCHES"),
    "quad_build": (quad_kernel, "LAUNCHES"),
    "quad_fold": (quad_kernel, "FOLD_LAUNCHES"),
    "blended_encode_fwd": (hash_encoding, "LAUNCHES"),
    "blended_encode_bwd": (hash_encoding, "BWD_LAUNCHES"),
}
# the kernels a forward pass alone (a render) launches
FORWARD = ("fused_mlp_fwd", "quad_build", "blended_encode_fwd")


def reset() -> None:
    for module, counter in COUNTERS.values():
        setattr(module, counter, 0)


def read(kernels=tuple(COUNTERS)) -> Dict[str, int]:
    return {name: getattr(*COUNTERS[name]) for name in kernels}
