"""PyTorch + CUDA port of ``nersemble_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``config``, ``utils/``, ``ops/``,
``models/``, ``engine/``, ``viewer/``) so each module's counterpart is easy
to find. The port imports ``torch`` and ``numpy`` (``scipy`` inside the
evaluation's host-side functions) — never ``jax``, ``yaml`` or the JAX
package — and keeps the JAX parameter layouts at its public boundary, so
checkpoints interchange (``engine/checkpoints.py``).

The Pallas TPU kernels on the render path are hand-written CUDA kernels
for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(``ops/cuda_lib.py``). On CPU tensors every kernel wrapper runs its plain
PyTorch version instead; on CUDA tensors it launches the kernel or raises.
"""
