"""B1-fwd's weight image and shared-memory plan (ops/fused_mlp.py
``fwd_weight_image``, ``fwd_layout``), on the CPU.

csrc/fused_mlp_fwd.cu reads its weights as swizzled [N][64] K blocks that
its wgmma descriptors name; the kernel itself runs only on the card, so here
the image is decoded in plain PyTorch, with the swizzle written out as index
arithmetic, and held bit for bit to ``pack_weights``' W^T blocks (which B2
reads unchanged), and the chain computed from the decoded image at the
kernel's padded widths is held to ``fused_mlp_plain`` within the kernel's
tolerance (``compare_to_plain``).
"""

import pytest
import torch
from test_torch_kernels import MLP_SHAPES

from nersemble_tpu_torch.ops import fused_mlp as tfm
from nersemble_tpu_torch.ops.mlp import activate, init_mlp, round_to
from nersemble_tpu_torch.utils.params import ParamTree

# the five kernel shapes, then widths that run padded to the next wgmma
# width (48 -> 64, 100 -> 128) with a skip, and single layers of 16, 64, 128
SHAPES = MLP_SHAPES + [
    (40, 24, 4, 48, (2,), True, "relu"),
    (21, 100, 3, 100, (), False, "sigmoid"),
    (32, 16, 1, 16, (), True, None),
    (18, 64, 1, 64, (), False, "relu"),
    (173, 128, 1, 128, (), True, "sigmoid"),
]


def _case(d_in, d_out, n_layers, width, skips, bias):
    g = torch.Generator().manual_seed(11)
    params = ParamTree(init_mlp(g, d_in, d_out, n_layers, width, skips, bias))
    wt, bias_p, per_layer, kx, _, _, _ = tfm.pack_weights(params, d_in, skips)
    layout = tfm.fwd_layout(per_layer, d_in, kx)
    return params, wt, bias_p, per_layer, kx, layout, tfm.fwd_weight_image(
        wt, per_layer, layout)


def _decode(image, layout):
    """Per layer the [N][KH + KX] bf16 matrix the kernel's descriptors read:
    element (r, k) of K block b lies at 2-byte index b * N * 64 + r * 64 +
    8 * ((k % 64 // 8) ^ (r % 8)) + k % 8 of the layer's chunks."""
    flat = image.view(torch.int16)
    mats = []
    for i, (width, kh, kx, *_) in enumerate(layout["layers"]):
        chunks = [c for c in layout["chunks"] if c[0] == i]
        assert all(c[2] == 128 * width for c in chunks)
        k_all = 64 * len(chunks)
        r = torch.arange(width)[:, None]
        k = torch.arange(k_all)[None, :]
        idx = (chunks[0][1] // 2 + (k // 64) * width * 64 + r * 64
               + 8 * (((k % 64) // 8) ^ (r % 8)) + k % 8)
        mats.append((flat[idx], kh + kx))
    return mats


@pytest.mark.parametrize("d_in,d_out,n_layers,width,skips,bias,out_act", SHAPES)
def test_fwd_weight_image_decodes_to_packed_blocks(d_in, d_out, n_layers, width,
                                                   skips, bias, out_act):
    _, wt, _, per_layer, _, layout, image = _case(d_in, d_out, n_layers, width,
                                                  skips, bias)
    assert image.dtype == torch.bfloat16
    assert 2 * image.numel() == layout["image_bytes"]
    packed = wt.view(torch.int16)
    for i, (mat, k_used) in enumerate(_decode(image, layout)):
        width_k, kh_k, kxl, n, _, _ = layout["layers"][i]
        _, kh, kxl_p, w_off, _ = per_layer[5 * i:5 * i + 5]
        assert kxl == kxl_p and kh_k == (layout["layers"][i - 1][0] if i else 0)
        block = packed[w_off:w_off + n * (kh + kxl)].view(n, kh + kxl)
        expected = torch.zeros_like(mat)
        expected[:n, :kh] = block[:, :kh]
        expected[:n, kh_k:kh_k + kxl] = block[:, kh:]
        assert torch.equal(mat, expected), f"layer {i}"
        assert k_used <= mat.shape[1] < k_used + 64


@pytest.mark.parametrize("d_in,d_out,n_layers,width,skips,bias,out_act", SHAPES)
def test_fwd_weight_image_computes_the_chain(d_in, d_out, n_layers, width, skips,
                                             bias, out_act):
    """The chain as the kernel runs it from the image: x rounded and
    zero-padded to kx, every layer at its padded width N, the hidden input
    as N columns of the layer before."""
    params, _, bias_p, _, kx, layout, image = _case(d_in, d_out, n_layers, width,
                                                    skips, bias)
    x = torch.randn(300, d_in, generator=torch.Generator().manual_seed(12))
    xs = torch.zeros(300, kx)
    xs[:, :d_in] = round_to(x, torch.bfloat16)
    h = None
    for i, (mat, _) in enumerate(_decode(image, layout)):
        width_k, kh, kxl, n, b_off, _ = layout["layers"][i]
        w = mat.view(torch.bfloat16).float()
        inp = torch.cat(([h] if kh else []) + ([xs[:, :kxl]] if kxl else []), dim=1)
        pre = inp @ w[:, :kh + kxl].t()
        if bias:
            pre[:, :n] += bias_p[b_off:b_off + n]
        if i < n_layers - 1:
            h = round_to(torch.relu(pre), torch.bfloat16)
        else:
            out = activate(pre[:, :d_out], out_act)
    tfm.compare_to_plain(out, tfm.fused_mlp_plain(params, x, out_act,
                                                  torch.bfloat16, skips))


def test_fwd_layout_of_the_flagship_mlps():
    """The stem streams 16 chunks of 16 KB through a 5-stage ring beside two
    64-row x tiles and one staging block each; the base and head keep their
    weights resident and stage x eight blocks ahead."""
    stem = _case(173, 128, 6, 128, (4,), True)[5]
    assert [c[0] for c in stem["chunks"]] == [0] * 3 + [1, 1, 2, 2, 3, 3] + [4] * 5 + [5, 5]
    assert (stem["stages"], stem["resident"], stem["stage_bytes"]) == (5, False, 16384)
    assert stem["x_stages"] == 1
    assert stem["image_bytes"] == 16 * 16384
    assert stem["smem_bytes"] + 1024 <= tfm._SMEM_LIMIT
    for shape, n_chunks in (((32, 16, 2, 64, (), False), 2), ((18, 3, 3, 64, (), False), 3)):
        plan = _case(*shape)[5]
        assert plan["resident"] and plan["stages"] == len(plan["chunks"]) == n_chunks
        assert plan["x_stages"] == tfm._FWD_MAX_X_STAGES
        assert plan["smem_bytes"] + 1024 <= tfm._SMEM_LIMIT
    for plan in (stem, _case(18, 3, 3, 64, (), False)[5]):
        assert plan["off_xa"] % 1024 == 0 and plan["stage_bytes"] % 1024 == 0
        assert plan["off_bias"] % 16 == 0 and plan["off_bars"] % 8 == 0
