"""Fused MLP: the CUDA kernels B1-fwd and B2 and their plain PyTorch versions.

Counterpart of nersemble_tpu/ops/fused_mlp.py. ``fused_mlp_apply`` is the
entry point, a ``torch.autograd.Function`` that saves ``x`` and the weights
(as ``_fused_vjp_fwd`` does) and recomputes the forward in its backward. On
CPU tensors it runs ``fused_mlp_plain`` / ``fused_mlp_bwd_plain``; on CUDA
tensors it launches ``csrc/fused_mlp_fwd.cu`` / ``csrc/fused_mlp_bwd.cu``
(see the notes at the top of those files for what each kernel replaces,
what bounds it and how) or raises. There is no fallback.
"""

import functools
from collections import Counter
from typing import Dict, List, Optional, Sequence

import torch

from nersemble_tpu_torch.ops import cuda_lib, launch_counts
from nersemble_tpu_torch.ops.mlp import activate, apply_mlp, round_to
from nersemble_tpu_torch.utils import spans

MAX_LAYERS = 8      # csrc/fused_mlp_fwd.cu MLP_MAX_LAYERS
MAX_WIDTH = 128     # widest layer one warpgroup's accumulators hold
_PAD = 8            # B2's shared-memory row padding (elements)
_SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use (H100)
# csrc/fused_mlp_fwd.cu: the wgmma widths it is built for (a layer runs at
# the next one up, zero-padded), rows per consumer warpgroup, consumers,
# ring stages, x staging blocks per consumer, chunks per tile; a chunk is
# one [N][64] K block of 128-byte rows
_FWD_WIDTHS = (16, 32, 64, 128)
_FWD_ROWS, _FWD_CONSUMERS, _FWD_MAX_STAGES, _FWD_MAX_X_STAGES = 64, 2, 8, 8
_FWD_MAX_CHUNKS = 64
_FWD_KBLOCK = 64
_ACTIVATIONS = {None: 0, "none": 0, "relu": 1, "sigmoid": 2}
# csrc/fused_mlp_bwd.cu BT, KC, NC, PASS, MAX_CHUNKS: rows per tile, staged
# K columns of the forward weights, staged out columns of dh's weight terms,
# dh input columns per pass, weight chunks per tile
_BWD_ROWS, _BWD_KC, _BWD_NC, _BWD_PASS, _BWD_MAX_CHUNKS = 64, 64, 32, 128, 96
# B2 runs every product on the tensor cores in bf16: g (f32) is split into
# _BWD_G_TERMS bf16 terms and the f32 weights into _BWD_W_TERMS, each term
# the round-to-nearest of what the ones before it left; dW takes the
# products h_in^T g_a (h_in is exact in bf16), dh the products g_a W_b^T
# with a + b <= _BWD_MAX_ORDER. Three terms of each with the six products of
# order <= 2 use under 5% of BWD_MAX_ERR_REL and BWD_MEAN_ERR_REL, while one
# term each (plain bf16 products) exceeds the mean bound over tenfold (CPU
# emulation with exact products and f32 sums at the flagship shapes,
# tests/test_torch_fused_mlp_split.py). Two terms (three products in dh)
# keep ~16 bits: enough for sums over many rows, not for the one-row case
# of tests/test_torch_kernels.py, where each dW element is a single product.
# On the card the tensor cores' own f32 accumulation adds the larger part
# of the error (chip_smoke.py prints the share used).
_BWD_G_TERMS, _BWD_W_TERMS, _BWD_MAX_ORDER = 3, 3, 2

# B1-fwd launches by (d_in, d_out, rows) while a caller holds a Counter here
# (chip_smoke.py's rows-per-launch histograms); None: not recorded
ROWS: Optional[Counter] = None

# B2 vs plain tolerance, per output (dx, every dW and db), held on
# ``positive_`` parameters and inputs. On random ones the bf16 forward that
# the backward recomputes is chaotic at the ulp level: another f32 summation
# order (or the tensor cores' own accumulation) flips a bf16 rounding in
# ~1e-4 of the stem's hidden activations and a relu sign about once per 2M,
# one sign flip in a middle layer moves a whole row of the (layer by layer
# shrinking) gradients, and dW sums ~10^5 terms of both signs. Two correct
# backwards then differ by up to 7% of max |dx| and 1.7e-3 of mean |dW| at
# 16,384 stem rows (the plain version with f64 sums against itself; CPU).
# On ``positive_`` values every relu sign is fixed by its column and every
# sum has terms of one sign, so at 98,304 rows the f64-sum version uses at
# most 1% of the mean bound and one with 1e-6 relative noise on every
# pre-activation at most 7%, while a backward that takes dh from the
# bf16-rounded weights exceeds it 20-630x and one that rounds the hidden
# gradients to bf16 (autograd through ``round_to``) 14-40x (stem, base and
# head, three seeds; CPU measurements, tests/test_torch_train_ops.py checks
# the second).
BWD_MAX_ERR_REL = 1e-3  # of max |plain|
BWD_MEAN_ERR_REL = 1e-5  # of mean |plain|

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


def _forward_chain(params, x: torch.Tensor, out_activation: Optional[str],
                   compute_dtype: torch.dtype, skip_connections: Sequence[int]):
    """The layer chain of ``_forward_math``: (output, the input of every
    layer after its skip concat)."""
    layers = params.layers
    skips = set(skip_connections)
    x_in = round_to(x, compute_dtype)
    h = x_in
    hs = []
    for i, layer in enumerate(layers):
        if i in skips and i > 0:
            h = torch.cat([h, x_in], dim=-1)
        hs.append(h)
        pre = h @ round_to(layer.w, compute_dtype)
        if "b" in layer:
            pre = pre + layer.b
        if i < len(layers) - 1:
            h = round_to(torch.relu(pre), compute_dtype)
        else:
            h = activate(pre, out_activation)
    return h, hs


def fused_mlp_plain(params, x: torch.Tensor,
                    out_activation: Optional[str] = None,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    skip_connections: Sequence[int] = ()) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: float32 products of operands
    rounded to ``compute_dtype``, f32 bias, relu then rounding on hidden
    layers, the output activation in float32."""
    return _forward_chain(params, x, out_activation, compute_dtype,
                          skip_connections)[0]


@torch.no_grad()
def fused_mlp_bwd_plain(params, x: torch.Tensor, g: torch.Tensor,
                        out_activation: Optional[str] = None,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        skip_connections: Sequence[int] = ()):
    """``_bwd_kernel`` transcribed: recompute the forward from ``x`` and the
    weights, then per layer (last first) ``dW = h_in^T g`` with ``h_in`` the
    rounded layer input in f32, ``db = sum g``, ``dh = g W^T`` with the
    **f32** weights, the skip layer's last ``d_in`` columns of dh to dx, and
    the relu mask of the rounded hidden activation. Returns (dx [N, d_in]
    f32, [dW_i] f32, [db_i] f32 or None)."""
    layers = params.layers
    skips = set(skip_connections)
    n_layers, in_dim = len(layers), x.shape[-1]
    out, hs = _forward_chain(params, x, out_activation, compute_dtype, skips)
    g = g.to(torch.float32)
    if out_activation == "sigmoid":
        g = g * out * (1.0 - out)
    elif out_activation == "relu":
        g = g * (out > 0).to(g.dtype)
    dx = torch.zeros(x.shape[0], in_dim, dtype=torch.float32, device=x.device)
    dws: List[torch.Tensor] = [None] * n_layers
    dbs = [None] * n_layers if "b" in layers[0] else None
    for i in range(n_layers - 1, -1, -1):
        dws[i] = hs[i].t() @ g
        if dbs is not None:
            dbs[i] = torch.sum(g, dim=0)
        dh = g @ layers[i].w.t()
        if i in skips and i > 0:
            dx = dx + dh[:, -in_dim:]
            dh = dh[:, :-in_dim]
        if i > 0:
            h_prev = hs[i][:, :dh.shape[-1]]
            g = dh * (h_prev > 0).to(dh.dtype)
        else:
            dx = dx + dh
    return dx, dws, dbs


def _compare(out: torch.Tensor, ref: torch.Tensor, max_rel: float,
             mean_rel: float, what: str) -> Dict[str, float]:
    err = (out.float() - ref).abs()
    scale = float(ref.abs().max())
    res = {"max_abs": float(err.max()),
           "max_rel": float(err.max()) / scale if scale else 0.0,
           "max_tol": max_rel * scale,
           "mean_abs": float(err.mean()),
           "mean_tol": mean_rel * float(ref.abs().mean())}
    if not (res["max_abs"] <= res["max_tol"] and res["mean_abs"] <= res["mean_tol"]):
        raise AssertionError(f"{what} differs from its plain version: {res}")
    return res


def compare_to_plain(out: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """Max abs error (also relative to max |ref|) and mean abs error of
    ``out`` against the plain version's ``ref``, with their limits; raises
    AssertionError when either limit is exceeded."""
    return _compare(out, ref, MAX_ERR_REL, MEAN_ERR_REL, "fused MLP")


def positive_(params, generator: torch.Generator):
    """Overwrite an MLP's parameters in place for B2's kernel-vs-plain check
    (``BWD_MAX_ERR_REL``): weights s_j * U(0.5, 1.5) / in_dim with a random
    sign s_j per output column, biases s_j * U(0, 0.1). With
    ``positive_input`` x (and output gradients) every pre-activation has
    its column's sign and every gradient stays >= 0."""
    with torch.no_grad():
        for layer in params.layers:
            kw = dict(generator=generator, device=generator.device)
            d_in, d_out = layer.w.shape
            sign = torch.randint(0, 2, (d_out,), **kw).to(layer.w.dtype) * 2 - 1
            layer.w.copy_(sign * (0.5 + torch.rand(layer.w.shape, **kw)) / d_in)
            if "b" in layer:
                layer.b.copy_(sign * 0.1 * torch.rand(d_out, **kw))
    return params


def positive_input(rows: int, width: int, generator: torch.Generator) -> torch.Tensor:
    """[rows, width] float32 values U(0.5, 1.5)."""
    return 0.5 + torch.rand(rows, width, generator=generator,
                            device=generator.device)


def compare_bwd_to_plain(outs, refs) -> Dict[str, float]:
    """``compare_to_plain`` for a backward's (dx, dWs, dbs) with the B2
    bounds, output by output; returns the worst of each number, and of the
    share of each tolerance used (``max_share``, ``mean_share``)."""
    (dx, dws, dbs), (rdx, rdws, rdbs) = outs, refs
    pairs = [("dx", dx, rdx)] + [(f"dW{i}", a, b) for i, (a, b)
                                 in enumerate(zip(dws, rdws))]
    if rdbs is not None:
        pairs += [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(dbs, rdbs))]
    worst: Dict[str, float] = {}
    for name, a, b in pairs:
        res = _compare(a, b, BWD_MAX_ERR_REL, BWD_MEAN_ERR_REL,
                       f"fused MLP backward {name}")
        res["max_share"] = res["max_abs"] / res["max_tol"] if res["max_tol"] else 0.0
        res["mean_share"] = res["mean_abs"] / res["mean_tol"] if res["mean_tol"] else 0.0
        for key in ("max_abs", "max_rel", "mean_abs", "max_share", "mean_share"):
            worst[key] = max(worst.get(key, 0.0), res[key])
    return worst


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


def _cached(params, tag: str, key, build):
    """``build()``, cached on the MLP module as its attribute ``tag`` until
    ``key`` or a weight changes (weights keyed by storage and version
    counter)."""
    full_key = (key, tuple((t.data_ptr(), t._version) for t in params.parameters()))
    cached = getattr(params, tag, None)
    if cached is None or cached[0] != full_key:
        cached = (full_key, build())
        setattr(params, tag, cached)
    return cached[1]


def _packed_weights(params, d_in: int, skip_connections: Sequence[int]):
    """``pack_weights``, cached on the MLP module (``_cached``): a render
    calls each MLP thousands of times with the same weights."""
    return _cached(params, "_fused_mlp_packed", (d_in, tuple(skip_connections)),
                   lambda: pack_weights(params, d_in, skip_connections))


def fwd_layout(per_layer, d_in: int, kx: int) -> Dict:
    """B1-fwd's plan from ``pack_weights``' per-layer list: per layer (N, KH,
    KX, packed width, packed bias offset, shared bias offset), with N the
    wgmma width the layer runs at and KH = the N of the layer before (its
    hidden input, from registers); the weight chunks as (layer, byte offset
    in the image, bytes), each a swizzled [N][64] K block; and the shared
    memory: a ring of ``stages`` chunk stages (``resident``: one per chunk,
    loaded once per launch), each consumer's bf16 x tile and its
    ``x_stages`` f32 x staging blocks (more where the weights are resident:
    more x copies in flight), the bias, the mbarriers. Raises ValueError
    when it does not fit."""
    layers, chunks = [], []
    off = sb = prev = 0
    for i in range(len(per_layer) // 5):
        n, _, kxl, _, b_off = per_layer[5 * i:5 * i + 5]
        width = next(w for w in _FWD_WIDTHS if w >= n)
        layers.append((width, prev, kxl, n, b_off, sb))
        for _ in range(-(-(prev + kxl) // _FWD_KBLOCK)):
            chunks.append((i, off, width * 2 * _FWD_KBLOCK))
            off += width * 2 * _FWD_KBLOCK
        sb += width
        prev = width
    if len(chunks) > _FWD_MAX_CHUNKS:
        raise ValueError(f"fused MLP streams {len(chunks)} weight chunks > {_FWD_MAX_CHUNKS}")
    stage_bytes = max(c[2] for c in chunks)
    xa = _FWD_CONSUMERS * -(-kx // _FWD_KBLOCK) * _FWD_ROWS * 2 * _FWD_KBLOCK
    x_block = _FWD_CONSUMERS * _FWD_ROWS * d_in * 4  # one block per consumer
    bias = -(-sb // 4) * 16
    bars = 8 * (2 * _FWD_MAX_STAGES + 2 * _FWD_CONSUMERS * _FWD_MAX_X_STAGES)
    room = _SMEM_LIMIT - 1024 - xa - bias - bars
    fit = min(_FWD_MAX_STAGES, (room - x_block) // stage_bytes)
    resident = len(chunks) <= fit
    stages = len(chunks) if resident else fit
    if stages < 2 and not resident:
        raise ValueError(f"fused MLP's weight ring fits {stages} stage(s) of "
                         f"{stage_bytes} B next to its x tiles")
    x_stages = (min(_FWD_MAX_X_STAGES, (room - stages * stage_bytes) // x_block)
                if resident else 1)
    off_xa = stages * stage_bytes
    off_bias = off_xa + xa + x_stages * x_block
    return {"layers": layers, "chunks": chunks, "image_bytes": off,
            "stages": stages, "resident": resident, "stage_bytes": stage_bytes,
            "x_stages": x_stages, "off_xa": off_xa, "off_xraw": off_xa + xa,
            "off_bias": off_bias, "off_bars": off_bias + bias,
            "smem_bytes": off_bias + bias + bars}


def fwd_weight_image(wt: torch.Tensor, per_layer, layout: Dict) -> torch.Tensor:
    """B1-fwd's weight image from ``pack_weights``' W^T blocks, on their
    device, in a few tensor ops (no host copy): per layer W^T zero-padded to
    [N][KH + KX] (the hidden columns, padded to KH, then the x columns) and
    to whole 64-column K blocks, each block stored as [N][64] bf16 rows of
    128 bytes whose 16-byte groups are swizzled: group g of row r at
    position g ^ (r % 8), the layout wgmma reads in its 128-byte swizzle."""
    parts = []
    for i, (width, kh_k, kxl, n, _, _) in enumerate(layout["layers"]):
        _, kh, _, w_off, _ = per_layer[5 * i:5 * i + 5]
        w = wt[w_off:w_off + n * (kh + kxl)].view(n, kh + kxl)
        k_pad = -(-(kh_k + kxl) // _FWD_KBLOCK) * _FWD_KBLOCK
        full = torch.zeros(width, k_pad, dtype=torch.bfloat16, device=wt.device)
        full[:n, :kh] = w[:, :kh]
        full[:n, kh_k:kh_k + kxl] = w[:, kh:]
        blocks = full.view(width, k_pad // _FWD_KBLOCK, 8, 8)
        rows = torch.arange(width, device=wt.device)
        src = torch.arange(8, device=wt.device)[None, :] ^ (rows[:, None] & 7)
        swizzled = torch.gather(blocks, 2, src[:, None, :, None].expand(blocks.shape))
        parts.append(swizzled.transpose(0, 1).reshape(-1))
    return torch.cat(parts)


def _fwd_operands(params, d_in: int, skip_connections: Sequence[int]):
    """B1-fwd's (image, bias, layout, kx, d_out, has_bias, {(activation,
    x aligned): meta}), cached on the MLP module like ``_packed_weights``
    (training rebuilds it every step); a render launches each MLP hundreds
    of times per frame with the same weights, so the meta arrays are kept."""
    def build():
        wt, bias, per_layer, kx, _, d_out, has_bias = _packed_weights(
            params, d_in, skip_connections)
        layout = fwd_layout(per_layer, d_in, kx)
        image = fwd_weight_image(wt, per_layer, layout)
        return image, bias, layout, kx, d_out, has_bias, {}
    return _cached(params, "_fused_mlp_fwd_image", (d_in, tuple(skip_connections)),
                   build)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_mlp_cuda(params, x: torch.Tensor, out_activation: Optional[str] = None,
                   skip_connections: Sequence[int] = ()) -> torch.Tensor:
    """Launch kernel B1-fwd on a CUDA tensor ``x [N, d_in]`` float32 (any
    alignment: x not 16-byte aligned is read without bulk copies)."""
    if not x.is_cuda:
        raise ValueError("fused_mlp_cuda takes a CUDA tensor")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if out_activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {out_activation!r}")
    image, bias, layout, kx, d_out, has_bias, metas = _fwd_operands(
        params, x.shape[1], skip_connections)
    if image.device != x.device:
        raise ValueError(f"weights on {image.device}, input on {x.device}")
    out = torch.empty(x.shape[0], d_out, dtype=torch.float32, device=x.device)
    if ROWS is not None:
        ROWS[(x.shape[1], d_out, x.shape[0])] += 1
    aligned = x.data_ptr() % 16 == 0
    meta = metas.get((out_activation, aligned))
    if meta is None:
        meta = metas[(out_activation, aligned)] = cuda_lib.int64_array(
            [len(layout["layers"]), x.shape[1], kx, d_out, _ACTIVATIONS[out_activation],
             int(has_bias), layout["stages"], int(layout["resident"]),
             layout["stage_bytes"], int(aligned), _sm_count(x.device),
             layout["smem_bytes"], layout["off_xa"], layout["off_xraw"],
             layout["off_bias"], layout["off_bars"], layout["image_bytes"],
             layout["x_stages"], *(v for entry in layout["layers"] for v in entry)])
    cuda_lib.run("fused_mlp_fwd", x.data_ptr(), out.data_ptr(), image.data_ptr(),
                 bias.data_ptr(), meta, x.shape[0],
                 torch.cuda.current_stream(x.device).cuda_stream)
    launch_counts.add("fused_mlp_fwd")
    return out


def bwd_layout(params, d_in: int, skip_connections: Sequence[int]):
    """B2's operands besides B1-fwd's packed ones: the f32 weights in their
    ``[in, out]`` layout, concatenated, and per layer (real input width,
    real output width, hidden input width, offset of W_i in that buffer =
    offset of dW_i in a partial, offset of db_i in a partial). A partial
    holds every dW_i as ``[out][in]`` (so a warp's RMW is coalesced), then
    every db_i; its length is rounded up to 4 floats."""
    layers = params.layers
    skips = set(skip_connections)
    per_layer, w_off, prev_out = [], 0, None
    for i, layer in enumerate(layers):
        d_out = layer.w.shape[1]
        hw = 0 if i == 0 else prev_out
        in_real = layer.w.shape[0]
        per_layer.append([in_real, d_out, hw, w_off])
        w_off += in_real * d_out
        prev_out = d_out
    b_off = w_off
    for entry, layer in zip(per_layer, layers):
        entry.append(b_off)
        if "b" in layer:
            b_off += entry[1]
    wf = torch.cat([layer.w.detach().reshape(-1) for layer in layers])
    return wf, per_layer, -(-b_off // 4) * 4


def _packed_bwd(params, d_in: int, skip_connections: Sequence[int]):
    """``bwd_layout``, cached on the MLP module like ``_packed_weights``."""
    return _cached(params, "_fused_mlp_bwd_packed", (d_in, tuple(skip_connections)),
                   lambda: bwd_layout(params, d_in, skip_connections))


def split_partial_sum(total: torch.Tensor, per_layer, has_bias: bool):
    """The reduced partial buffer -> ([dW_i [in, out]], [db_i] or None)."""
    dws, dbs = [], [] if has_bias else None
    for in_real, d_out, _, w_off, b_off in per_layer:
        dws.append(total[w_off:w_off + in_real * d_out].view(d_out, in_real)
                   .t().contiguous())
        if has_bias:
            dbs.append(total[b_off:b_off + d_out].clone())
    return dws, dbs


def bwd_smem_bytes(per_layer_fwd, kx: int, h_stride: int) -> int:
    """B2's shared memory (csrc/fused_mlp_bwd.cu bwd_smem_bytes): the bf16
    x tile and hidden activations, g's terms, two staging buffers, the bias
    gradient's column sums, three mbarriers and every layer's bias."""
    n_layers = len(per_layer_fwd) // 5
    widths = [per_layer_fwd[5 * i] for i in range(n_layers)]
    n_max = max(widths)
    stage = max(n_max * (_BWD_KC + _PAD),
                _BWD_W_TERMS * _BWD_PASS * (_BWD_NC + _PAD))
    return (2 * _BWD_ROWS * (kx + _PAD) + 2 * (n_layers - 1) * _BWD_ROWS * h_stride
            + 2 * _BWD_G_TERMS * _BWD_ROWS * (n_max + _PAD) + 2 * 2 * stage
            + 4 * 2 * n_max + 8 * 3 + 4 * sum(widths))


def bwd_work(params, n_rows: int, n_parts: int) -> Dict[str, float]:
    """B2's work on ``n_rows`` rows, for its bounds. ``bf16_flops``: the
    tensor-core products it runs (the forward recompute, dW's G products,
    dh's products); ``f32_flops``: dW and dh as f32 products, the CUDA-core
    route of the function (then ``fwd_flops`` in bf16); ``bytes``: x and g
    read, dx written, the weights read and dW, db written once;
    ``partial_bytes``: the design's own traffic, each 64-row tile reading and
    writing its block's f32 partial, each of ``n_parts`` blocks zeroing its
    partial and the final sum reading them all."""
    layers = params.layers
    d_in, d_out = layers[0].w.shape[0], layers[-1].w.shape[1]
    macs = sum(layer.w.numel() for layer in layers)
    weight_bytes = 4 * sum(p.numel() for p in params.parameters())
    part_bytes = 4 * bwd_partial_floats(
        [tuple(layer.w.shape) for layer in layers], "b" in layers[0])
    n_tiles = -(-n_rows // _BWD_ROWS)
    products = 1 + _BWD_G_TERMS + len(bwd_products())
    return {"bf16_flops": 2.0 * macs * n_rows * products,
            "fwd_flops": 2.0 * macs * n_rows,
            "f32_flops": 4.0 * macs * n_rows,
            "bytes": 4.0 * n_rows * (2 * d_in + d_out) + 2.0 * weight_bytes,
            "partial_bytes": float(part_bytes) * (2 * n_tiles + 2 * n_parts)}


def bwd_partial_floats(per_layer_bwd, has_bias: bool) -> int:
    """Floats of one of B2's per-block partials: every dW_i as [out][in
    rounded up to 4] (so that 4 neighbouring columns are one 16-byte
    reduction), then every db_i, rounded up to 4."""
    n = sum(out_real * -(-in_real // 4) * 4 for in_real, out_real, *_ in per_layer_bwd)
    if has_bias:
        n += sum(out_real for _, out_real, *_ in per_layer_bwd)
    return -(-n // 4) * 4


def bwd_stream_chunks(per_layer_fwd) -> List[int]:
    """The bf16 sizes of the chunks of B2's weight stream (csrc/
    fused_mlp_bwd.cu Chunk): per layer the forward's K chunks of n x (KC +
    PAD), and per dh pass (PASS packed input columns) its out-column chunks
    of W terms x rows x (NC + PAD)."""
    sizes = []
    for i in range(len(per_layer_fwd) // 5):
        n, kh, kxl = per_layer_fwd[5 * i:5 * i + 3]
        k_l = kh + kxl
        sizes += [n * (_BWD_KC + _PAD)] * -(-k_l // _BWD_KC)
        for p0 in range(0, k_l, _BWD_PASS):
            rows = min(_BWD_PASS, k_l - p0)
            sizes += [_BWD_W_TERMS * rows * (_BWD_NC + _PAD)] * -(-n // _BWD_NC)
    return sizes


def bwd_products() -> List[tuple]:
    """The (g term, weight term) pairs whose products B2's dh sums."""
    return [(a, b) for a in range(_BWD_G_TERMS) for b in range(_BWD_W_TERMS)
            if a + b <= _BWD_MAX_ORDER]


def fused_mlp_bwd_cuda(params, x: torch.Tensor, g: torch.Tensor,
                       out_activation: Optional[str] = None,
                       skip_connections: Sequence[int] = ()):
    """Launch kernel B2 on CUDA tensors ``x [N, d_in]`` and ``g [N, d_out]``
    (float32): returns (dx, [dW_i], [db_i] or None), all f32."""
    if not (x.is_cuda and g.is_cuda):
        raise ValueError("fused_mlp_bwd_cuda takes CUDA tensors")
    for name, t in (("x", x), ("g", g)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D float32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if out_activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {out_activation!r}")
    n_rows, d_in = x.shape
    wt, bias, per_layer, kx, h_stride, d_out, has_bias = _packed_weights(
        params, d_in, skip_connections)
    wf, per_layer_bwd, part_stride = _packed_bwd(params, d_in, skip_connections)
    if g.shape != (n_rows, d_out):
        raise ValueError(f"g is {tuple(g.shape)}, expected {(n_rows, d_out)}")
    if wt.device != x.device:
        raise ValueError(f"weights on {wt.device}, input on {x.device}")
    smem = bwd_smem_bytes(per_layer, kx, h_stride)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused MLP backward needs {smem} B of shared memory "
                         f"> {_SMEM_LIMIT}")
    n_tiles = -(-n_rows // _BWD_ROWS)
    n_parts = max(1, min(n_tiles, torch.cuda.get_device_properties(
        x.device).multi_processor_count))
    dx = torch.empty(n_rows, d_in, dtype=torch.float32, device=x.device)
    # the weight stream: every staged chunk's bf16 image, packed by the
    # kernel's entry point from wt and wf (split into terms) at each call
    # (training changes the weights every step)
    n_layers = len(per_layer) // 5
    chunks = bwd_stream_chunks(per_layer)
    if len(chunks) > _BWD_MAX_CHUNKS:
        raise ValueError(f"fused MLP backward streams {len(chunks)} weight chunks "
                         f"> {_BWD_MAX_CHUNKS}")
    stream_elems = sum(chunks)
    wstream = torch.empty(stream_elems, dtype=torch.bfloat16, device=x.device)
    partial_floats = bwd_partial_floats(per_layer_bwd, has_bias)
    partials = torch.empty(n_parts, partial_floats, dtype=torch.float32,
                           device=x.device)
    total = torch.empty(part_stride, dtype=torch.float32, device=x.device)
    meta = [n_layers, d_in, kx, d_out, _ACTIVATIONS[out_activation],
            h_stride, int(has_bias), part_stride, _BWD_G_TERMS, _BWD_W_TERMS,
            _BWD_MAX_ORDER, stream_elems, partial_floats]
    for i, (in_real, out_real, hw, w_off, b_off) in enumerate(per_layer_bwd):
        meta += [*per_layer[5 * i:5 * i + 5], in_real, out_real, hw, w_off, b_off]
    cuda_lib.run(
        "fused_mlp_bwd", x.data_ptr(), g.data_ptr(), dx.data_ptr(), wt.data_ptr(),
        bias.data_ptr(), wf.data_ptr(), wstream.data_ptr(), partials.data_ptr(),
        total.data_ptr(), cuda_lib.int64_array(meta), n_rows, n_parts,
        torch.cuda.current_stream(x.device).cuda_stream)
    launch_counts.add("fused_mlp_bwd")
    dws, dbs = split_partial_sum(total, per_layer_bwd, has_bias)
    return dx, dws, dbs


class _FusedMLP(torch.autograd.Function):
    """Forward B1-fwd / backward B2 (CUDA) or the plain pair (CPU); saves
    ``x`` and the weights and recomputes the activations in the backward."""

    @staticmethod
    def forward(ctx, x, params, out_activation, compute_dtype, skips, *weights):
        ctx.save_for_backward(x, *weights)
        ctx.params, ctx.out_activation = params, out_activation
        ctx.compute_dtype, ctx.skips = compute_dtype, skips
        if x.device.type == "cpu":
            return fused_mlp_plain(params, x, out_activation, compute_dtype, skips)
        return fused_mlp_cuda(params, x, out_activation, skips)

    @staticmethod
    def backward(ctx, g):
        x = ctx.saved_tensors[0]
        params = ctx.params
        with spans.span("bwd:fused_mlp"):
            if x.device.type == "cpu":
                dx, dws, dbs = fused_mlp_bwd_plain(params, x, g, ctx.out_activation,
                                                   ctx.compute_dtype, ctx.skips)
            else:
                dx, dws, dbs = fused_mlp_bwd_cuda(params, x, g.contiguous(),
                                                  ctx.out_activation, ctx.skips)
        return (dx, None, None, None, None, *dws, *(dbs or ()))


def fused_mlp_apply(params, x: torch.Tensor,
                    out_activation: Optional[str] = None,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    skip_connections: Sequence[int] = ()) -> torch.Tensor:
    """The MLP chain through kernels B1-fwd / B2 (CUDA) or their plain
    versions (CPU), differentiable in ``x`` and every weight and bias.

    The kernels compute in bf16; a CUDA call with another compute dtype
    raises rather than silently taking the plain path."""
    if out_activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {out_activation!r}")
    if x.device.type != "cpu" and compute_dtype != torch.bfloat16:
        raise ValueError(f"the fused MLP kernel computes in bfloat16, not {compute_dtype}")
    layers = params.layers
    tensors = [layer.w for layer in layers]
    if "b" in layers[0]:
        tensors += [layer.b for layer in layers]
    return _FusedMLP.apply(x, params, out_activation, compute_dtype,
                           tuple(skip_connections), *tensors)


def mlp_apply(use_fused_mlp: bool):
    """The MLP chain of the ``use_fused_mlp`` config flag: ``fused_mlp_apply``
    (kernels B1-fwd / B2 on CUDA, their plain versions on the CPU), or the
    JAX package's unfused ``apply_mlp``, one matmul per layer on every
    device."""
    return fused_mlp_apply if use_fused_mlp else apply_mlp
