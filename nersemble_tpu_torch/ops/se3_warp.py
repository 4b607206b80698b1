"""The SE(3) deformation field's elementwise chain: the stem's input encoding
and the exponential map of the head's screw axis with its NaN guard, as the
CUDA kernels of ``csrc/se3_warp.cu`` on the card, and the plain chain on
the CPU.

- ``warp_input(positions, code, n_freq, window_param)``: the stem's input
  [N, 6F + 3 + D]: ``windowed_posenc`` of the AABB-normalised positions (F
  frequencies 2^0..2^(F-1), the input appended), then the warp code. On the
  card one launch (``warp_input``); its backward hands columns 6F + 3: of the
  gradient to the code, as the concatenation's does.
- ``se3_offsets(head, positions)``: the offsets [N, 3] of the exponential
  map of the head's first 6 columns ``[v, r]`` applied to the positions,
  NaN-guarded: a row whose warp is NaN anywhere takes the position in those
  coordinates, and no gradient. On the card one launch forward
  (``se3_warp_fwd``, which also keeps a compact copy of the screw for the
  backward) and one backward (``se3_warp_bwd``, the closed-form derivative
  that autograd gives the plain chain, written into the head's gradient
  [N, H], zero past column 6).

The device alone picks the path. CPU tensors take the plain chain
(``windowed_posenc`` and ``torch.cat``, ``se3_offsets_plain``), which the
tests hold to the JAX package and the kernels to. The kernels give the
positions no gradient, so on the card positions that require one are refused
with a ValueError: differentiate the warp with respect to the field's
parameters and the warp code.
"""

from typing import Optional

import torch

from nersemble_tpu_torch.ops import cuda_lib, launch_counts
from nersemble_tpu_torch.ops.posenc import windowed_posenc
from nersemble_tpu_torch.utils.se3 import se3_apply

MAX_FREQ = 32  # csrc/se3_warp.cu SW_MAX_FREQ
SCREW = 6  # the head's columns the warp reads: v, then r


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _rows(x: torch.Tensor, width: int, name: str) -> torch.Tensor:
    """``x`` as f32 rows [N, >= width] with unit column stride (a view
    where it is one)."""
    if x.dim() != 2 or x.shape[1] < width:
        raise ValueError(f"{name} must be [N, >= {width}], not {tuple(x.shape)}")
    x = x.to(torch.float32)
    return x if x.stride(1) == 1 or x.shape[1] == 1 else x.contiguous()


def _on_card(*tensors: torch.Tensor) -> torch.device:
    device = tensors[0].device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"the SE(3) warp kernels take CUDA tensors on one card, not "
                         f"{[str(t.device) for t in tensors]}")
    return device


def _takes_kernels(positions: torch.Tensor) -> bool:
    """Whether the kernels take this warp: positions on a CUDA device, which
    then may not require a gradient (the kernels give them none)."""
    if positions.device.type != "cuda":
        return False
    if torch.is_grad_enabled() and positions.requires_grad:
        raise ValueError("the SE(3) warp kernels give the positions no gradient: on the "
                         "card differentiate the warp with respect to the field's parameters "
                         "and the warp code only")
    return True


# ---- the stem's input --------------------------------------------------------

def warp_input_cuda(positions: torch.Tensor, code: torch.Tensor, n_freq: int,
                    window_param: Optional[float] = None) -> torch.Tensor:
    """The stem's input [N, 6 n_freq + 3 + D] f32 from positions [N, 3] and
    the warp code [N, D] on the card: one launch, no host read."""
    device = _on_card(positions, code)
    pos, codes = _rows(positions, 3, "positions"), _rows(code, 0, "code")
    n, d = pos.shape[0], codes.shape[1]
    if codes.shape[0] != n:
        raise ValueError(f"{codes.shape[0]} code rows for {n} positions")
    if not 0 <= n_freq <= MAX_FREQ:
        raise ValueError(f"the warp-input kernel takes 0 to {MAX_FREQ} frequencies, "
                         f"not {n_freq}")
    out = torch.empty(n, 6 * n_freq + 3 + d, dtype=torch.float32, device=device)
    if n:
        cuda_lib.run("warp_input", pos.data_ptr(), pos.stride(0), codes.data_ptr(),
                     codes.stride(0), out.data_ptr(), n, n_freq, d,
                     0.0 if window_param is None else float(window_param),
                     int(window_param is not None), _stream(device))
        launch_counts.add("warp_input")
    return out


class _WarpInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, code, n_freq, window_param):
        ctx.split = 6 * n_freq + 3
        return warp_input_cuda(positions, code, n_freq, window_param)

    @staticmethod
    def backward(ctx, g):
        return None, g[:, ctx.split:], None, None


def warp_input(positions: torch.Tensor, code: torch.Tensor, n_freq: int,
               window_param: Optional[float] = None) -> torch.Tensor:
    """The deformation stem's input: the kernel on the card, else
    ``windowed_posenc`` and the concatenation."""
    if _takes_kernels(positions):
        return _WarpInput.apply(positions, code, n_freq, window_param)
    enc = windowed_posenc(positions, n_freq, min_freq_exp=0.0, max_freq_exp=n_freq - 1,
                          include_input=True, window_param=window_param)
    return torch.cat([enc, code.to(enc.dtype)], dim=-1)


# ---- the exponential map -----------------------------------------------------

def se3_offsets_plain(screw: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The guarded warp's offsets from a [N, 6] f32 screw (the JAX guard:
    ``where(isnan(warped), pos, warped)``), with its backward kept finite:
    rows whose warp is NaN somewhere take the JAX values without a gradient,
    and ``se3_apply`` differentiates a zero screw there instead of the one
    that gave NaN (the double-where pattern)."""
    with torch.no_grad():
        raw = se3_apply(screw, positions)
    bad = torch.isnan(raw)
    row_bad = bad.any(dim=-1, keepdim=True)
    safe = se3_apply(torch.where(row_bad, torch.zeros_like(screw), screw), positions)
    warped = torch.where(row_bad, torch.where(bad, positions, raw), safe)
    return warped - positions


def se3_warp_fwd_cuda(head: torch.Tensor, positions: torch.Tensor):
    """(offsets [N, 3], screw [N, 6]) f32 from the head's output [N, >= 6]
    (its first 6 columns read in place) and positions [N, 3] on the card:
    one launch, no host read."""
    device = _on_card(head, positions)
    h, pos = _rows(head, SCREW, "head"), _rows(positions, 3, "positions")
    n = h.shape[0]
    if pos.shape[0] != n:
        raise ValueError(f"{pos.shape[0]} positions for {n} head rows")
    off = torch.empty(n, 3, dtype=torch.float32, device=device)
    screw = torch.empty(n, SCREW, dtype=torch.float32, device=device)
    if n:
        cuda_lib.run("se3_warp_fwd", h.data_ptr(), h.stride(0), pos.data_ptr(), pos.stride(0),
                     off.data_ptr(), screw.data_ptr(), n, _stream(device))
        launch_counts.add("se3_warp_fwd")
    return off, screw


def se3_warp_bwd_cuda(grad: torch.Tensor, screw: torch.Tensor, positions: torch.Tensor,
                      width: int) -> torch.Tensor:
    """The head's gradient [N, width] f32 (zero past column 6, and on rows
    the guard replaced) from the offsets' gradient [N, 3], the screw [N, 6]
    that ``se3_warp_fwd_cuda`` kept and the positions, on the card: one
    launch, no host read. The kernel writes whole float4s: a width that is
    not a multiple of 4 gets a view of a wider buffer."""
    device = _on_card(grad, screw, positions)
    g, pos = _rows(grad, 3, "grad"), _rows(positions, 3, "positions")
    s = screw.to(torch.float32).contiguous()
    n = g.shape[0]
    if s.shape != (n, SCREW) or pos.shape[0] != n:
        raise ValueError(f"grad {tuple(g.shape)}, screw {tuple(s.shape)} and positions "
                         f"{tuple(pos.shape)} differ in rows")
    if width < SCREW:
        raise ValueError(f"the head's gradient has at least {SCREW} columns, not {width}")
    padded = -(-width // 4) * 4
    out = torch.empty(n, padded, dtype=torch.float32, device=device)
    if n:
        cuda_lib.run("se3_warp_bwd", g.data_ptr(), g.stride(0), s.data_ptr(), pos.data_ptr(),
                     pos.stride(0), out.data_ptr(), n, padded, _stream(device))
        launch_counts.add("se3_warp_bwd")
    return out[:, :width]


class _SE3Warp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, head, positions):
        off, screw = se3_warp_fwd_cuda(head, positions)
        ctx.save_for_backward(screw, positions)
        ctx.width = head.shape[1]
        return off

    @staticmethod
    def backward(ctx, g):
        screw, positions = ctx.saved_tensors
        return se3_warp_bwd_cuda(g, screw, positions, ctx.width), None


def se3_offsets(head: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The guarded warp's offsets [N, 3] f32 from the head's output [N, H]
    (columns 0:3 v, 3:6 r) and positions [N, 3]: the kernels on the card,
    else ``se3_offsets_plain``."""
    if _takes_kernels(positions):
        return _SE3Warp.apply(head, positions)
    return se3_offsets_plain(head[:, :SCREW].to(torch.float32),
                             positions.to(torch.float32))
