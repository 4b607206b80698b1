"""Fused MLP forward: the CUDA kernel B1-fwd and its plain PyTorch version.

Counterpart of nersemble_tpu/ops/fused_mlp.py (forward only; the backward
kernel comes with training). ``fused_mlp_apply`` is the entry point: on a
CPU tensor it runs ``fused_mlp_plain``; on a CUDA tensor it launches
``csrc/fused_mlp_fwd.cu`` (see the note at the top of that file for what the
kernel replaces, what bounds it and how) or raises. There is no fallback.
"""

from typing import Dict, Optional, Sequence

import torch

from nersemble_tpu_torch.ops import cuda_lib
from nersemble_tpu_torch.ops.mlp import activate, round_to

MAX_LAYERS = 8      # csrc/fused_mlp_fwd.cu MLP_MAX_LAYERS
MAX_WIDTH = 128     # widest layer one warp's accumulators hold
_PAD = 8            # shared-memory row padding (elements)
_TILE_ROWS = 128
_SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use (H100)
_ACTIVATIONS = {None: 0, "none": 0, "relu": 1, "sigmoid": 2}

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)

# Kernel vs plain tolerance. The two sum the f32 products in different
# orders, so now and then a hidden activation rounds to the neighbouring
# bf16 value and carries that forward: the max error stays under half a
# bf16 ulp of the largest output, the mean error near zero. A kernel that
# skipped a bf16 rounding point (of x or of the hidden activations) moves
# nearly every output instead: at the flagship shapes its mean error is
# 9-150x MEAN_ERR_REL (tests/test_torch_ops.py checks that it fails).
MAX_ERR_REL = 2.0 ** -9  # of max |plain|
MEAN_ERR_REL = 1e-5      # of mean |plain|


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def fused_mlp_plain(params, x: torch.Tensor,
                    out_activation: Optional[str] = None,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    skip_connections: Sequence[int] = ()) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: float32 products of operands
    rounded to ``compute_dtype``, f32 bias, relu then rounding on hidden
    layers, the output activation in float32."""
    layers = params.layers
    skips = set(skip_connections)
    x_in = round_to(x, compute_dtype)
    h = x_in
    for i, layer in enumerate(layers):
        if i in skips and i > 0:
            h = torch.cat([h, x_in], dim=-1)
        pre = h @ round_to(layer.w, compute_dtype)
        if "b" in layer:
            pre = pre + layer.b
        if i < len(layers) - 1:
            h = round_to(torch.relu(pre), compute_dtype)
        else:
            h = activate(pre, out_activation)
    return h


def compare_to_plain(out: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """Max abs error (also relative to max |ref|) and mean abs error of
    ``out`` against the plain version's ``ref``, with their limits; raises
    AssertionError when either limit is exceeded."""
    err = (out.float() - ref).abs()
    scale = float(ref.abs().max())
    res = {"max_abs": float(err.max()),
           "max_rel": float(err.max()) / scale,
           "max_tol": MAX_ERR_REL * scale,
           "mean_abs": float(err.mean()),
           "mean_tol": MEAN_ERR_REL * float(ref.abs().mean())}
    if not (res["max_abs"] <= res["max_tol"] and res["mean_abs"] <= res["mean_tol"]):
        raise AssertionError(f"fused MLP differs from its plain version: {res}")
    return res


def pack_weights(params, d_in: int, skip_connections: Sequence[int] = ()):
    """Kernel operands from ``[in, out]`` f32 weights: one bf16 buffer of
    transposed, zero-padded ``W_i^T [n_i][kh_i + kx_i]`` blocks, one f32 bias
    buffer, and the int64 layout ``meta`` the C entry point reads (without
    its leading 7 header fields, which depend on the call)."""
    layers = params.layers
    n_layers = len(layers)
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"fused MLP takes 1..{MAX_LAYERS} layers, got {n_layers}")
    skips = set(skip_connections)
    kx = _pad16(d_in)
    device = layers[0].w.device
    blocks, biases, per_layer = [], [], []
    w_off = b_off = 0
    prev_out = None
    for i, layer in enumerate(layers):
        w = layer.w
        d_out = w.shape[1]
        n = _pad16(d_out)
        if n > MAX_WIDTH:
            raise ValueError(f"layer {i} is {d_out} wide; the kernel takes <= {MAX_WIDTH}")
        if i == 0:
            kh, kxl, h_w = 0, kx, 0
        elif i in skips:
            kh, kxl, h_w = _pad16(prev_out), kx, prev_out
        else:
            kh, kxl, h_w = _pad16(prev_out), 0, prev_out
        expected = h_w + (d_in if kxl else 0)
        if w.shape[0] != expected:
            raise ValueError(f"layer {i} takes {w.shape[0]} inputs, expected {expected}")
        wt = torch.zeros(n, kh + kxl, dtype=torch.bfloat16, device=device)
        wt_f = w.t().to(torch.bfloat16)
        wt[:d_out, :h_w] = wt_f[:, :h_w]
        if kxl:
            wt[:d_out, kh:kh + d_in] = wt_f[:, h_w:]
        blocks.append(wt.reshape(-1))
        b = torch.zeros(n, dtype=torch.float32, device=device)
        if "b" in layer:
            b[:d_out] = layer.b
        biases.append(b)
        per_layer += [n, kh, kxl, w_off, b_off]
        w_off += wt.numel()
        b_off += n
        prev_out = d_out
    hidden = [per_layer[5 * i] for i in range(n_layers - 1)]
    h_stride = max(hidden, default=16) + _PAD
    return (torch.cat(blocks), torch.cat(biases), per_layer, kx, h_stride,
            prev_out, "b" in layers[0])


def _packed_weights(params, d_in: int, skip_connections: Sequence[int]):
    """``pack_weights``, cached on the MLP module until a weight changes
    (keyed by storage and version counter): a render calls each MLP
    thousands of times with the same weights."""
    key = (d_in, tuple(skip_connections),
           tuple((t.data_ptr(), t._version) for t in params.parameters()))
    cached = getattr(params, "_fused_mlp_packed", None)
    if cached is None or cached[0] != key:
        cached = (key, pack_weights(params, d_in, skip_connections))
        params._fused_mlp_packed = cached
    return cached[1]


def smem_bytes(per_layer, kx: int, h_stride: int) -> int:
    w_max = max(per_layer[5 * i] * (per_layer[5 * i + 1] + per_layer[5 * i + 2] + _PAD)
                for i in range(len(per_layer) // 5))
    return 2 * (_TILE_ROWS * (kx + _PAD) + _TILE_ROWS * h_stride + w_max)


def fused_mlp_cuda(params, x: torch.Tensor, out_activation: Optional[str] = None,
                   skip_connections: Sequence[int] = ()) -> torch.Tensor:
    """Launch kernel B1-fwd on a CUDA tensor ``x [N, d_in]`` float32."""
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError("fused_mlp_cuda takes a CUDA tensor")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if out_activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {out_activation!r}")
    wt, bias, per_layer, kx, h_stride, d_out, has_bias = _packed_weights(
        params, x.shape[1], skip_connections)
    if wt.device != x.device:
        raise ValueError(f"weights on {wt.device}, input on {x.device}")
    smem = smem_bytes(per_layer, kx, h_stride)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused MLP needs {smem} B of shared memory > {_SMEM_LIMIT}")
    out = torch.empty(x.shape[0], d_out, dtype=torch.float32, device=x.device)
    meta = cuda_lib.int64_array(
        [len(per_layer) // 5, x.shape[1], kx, d_out,
         _ACTIVATIONS[out_activation], h_stride, int(has_bias), *per_layer])
    status = cuda_lib.library().fused_mlp_fwd(
        x.data_ptr(), out.data_ptr(), wt.data_ptr(), bias.data_ptr(), meta,
        x.shape[0], torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(status, "fused_mlp_fwd")
    LAUNCHES += 1
    return out


def fused_mlp_apply(params, x: torch.Tensor,
                    out_activation: Optional[str] = None,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    skip_connections: Sequence[int] = ()) -> torch.Tensor:
    """The MLP chain through kernel B1-fwd (CUDA) or its plain version (CPU).

    The kernel computes in bf16; a CUDA call with another compute dtype
    raises rather than silently taking the plain path."""
    if x.device.type == "cpu":
        return fused_mlp_plain(params, x, out_activation, compute_dtype,
                               skip_connections)
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"the fused MLP kernel computes in bfloat16, not {compute_dtype}")
    return fused_mlp_cuda(params, x, out_activation, skip_connections)

