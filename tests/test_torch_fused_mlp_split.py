"""B2's bf16 term split, emulated in plain PyTorch on the CPU.

csrc/fused_mlp_bwd.cu runs the fused MLP backward's f32 products on the
tensor cores by splitting each f32 operand into bf16 terms (each the
round-to-nearest of what the terms before it left): g into
``fused_mlp._BWD_G_TERMS`` terms, the f32 weights into ``_BWD_W_TERMS``;
dW sums h_in^T g_a over the g terms (h_in is exact in bf16) and dh sums the
products g_a W_b^T that ``fused_mlp.bwd_products()`` lists. The emulation
below does the same with exact bf16 x bf16 products summed in f32, at the
flagship stem, base and head shapes on ``positive_`` inputs, and holds it
to ``fused_mlp_bwd_plain`` with B2's own bound (``compare_bwd_to_plain``:
max error <= 1e-3 of max |plain|, mean error <= 1e-5 of mean |plain|): the
kernel's split uses under 5% of either tolerance, which leaves the tensor
cores' own accumulation room. A split of one term each (plain bf16
products) must exceed the mean tolerance more than tenfold, so the bound
can tell the two apart. (fused_mlp_bwd_plain is held to the JAX
Pallas kernel in tests/test_torch_train_ops.py.)
"""

import pytest
import torch

from chip_smoke import mlp_shapes
from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.ops import fused_mlp as tfm
from nersemble_tpu_torch.ops.mlp import init_mlp
from nersemble_tpu_torch.utils.params import ParamTree

ROWS = 8192
SHAPES = mlp_shapes(flagship_model_config(tiny=False))


def split_terms(t: torch.Tensor, n_terms: int):
    """``t`` (f32) -> ``n_terms`` bf16 values (kept f32), each the rounding
    of what the ones before left."""
    terms, rest = [], t.float()
    for _ in range(n_terms):
        term = rest.to(torch.bfloat16).float()
        terms.append(term)
        rest = rest - term
    return terms


@torch.no_grad()
def split_bwd(params, x, g, act, skips, g_terms, w_terms, products):
    """fused_mlp_bwd_plain with every dW and dh product taken over the
    operands' bf16 terms; db and dx sum in f32."""
    layers = params.layers
    n_layers, d_in = len(layers), x.shape[1]
    out, hs = tfm._forward_chain(params, x, act, torch.bfloat16, skips)
    g = g.float()
    if act == "sigmoid":
        g = g * out * (1.0 - out)
    elif act == "relu":
        g = g * (out > 0).float()
    dx = torch.zeros(x.shape[0], d_in)
    dws = [None] * n_layers
    dbs = [None] * n_layers if "b" in layers[0] else None
    for i in range(n_layers - 1, -1, -1):
        gs, ws = split_terms(g, g_terms), split_terms(layers[i].w, w_terms)
        dws[i] = sum(hs[i].t() @ term for term in gs)
        if dbs is not None:
            dbs[i] = g.sum(0)
        dh = sum(gs[a] @ ws[b].t() for a, b in products)
        if i in skips and i > 0:
            dx = dx + dh[:, -d_in:]
            dh = dh[:, :-d_in]
        if i > 0:
            g = dh * (hs[i][:, :dh.shape[1]] > 0).float()
        else:
            dx = dx + dh
    return dx, dws, dbs


def _case(shape):
    d_in, d_out, n_layers, width, skips, bias, act = SHAPES[shape]
    gen = torch.Generator().manual_seed(13)
    params = tfm.positive_(ParamTree(init_mlp(gen, d_in, d_out, n_layers, width,
                                              skips, bias)), gen)
    x = tfm.positive_input(ROWS, d_in, gen)
    g = tfm.positive_input(ROWS, d_out, gen)
    ref = tfm.fused_mlp_bwd_plain(params, x, g, act, torch.bfloat16, skips)
    return params, x, g, act, skips, ref


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_split_passes_the_bwd_bound(shape):
    params, x, g, act, skips, ref = _case(shape)
    products = tfm.bwd_products()
    assert (0, 0) in products and len(products) >= 3
    out = split_bwd(params, x, g, act, skips, tfm._BWD_G_TERMS, tfm._BWD_W_TERMS,
                    products)
    res = tfm.compare_bwd_to_plain(out, ref)
    assert res["max_share"] < 0.05 and res["mean_share"] < 0.05, res


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_one_term_split_fails_the_bwd_bound(shape):
    params, x, g, act, skips, ref = _case(shape)
    out = split_bwd(params, x, g, act, skips, 1, 1, [(0, 0)])
    with pytest.raises(AssertionError):
        tfm.compare_bwd_to_plain(out, ref)
    (dx, dws, _), (rdx, rdws, _) = out, ref
    mean_share = max(float((a - b).abs().mean())
                     / (tfm.BWD_MEAN_ERR_REL * float(b.abs().mean()))
                     for a, b in [(dx, rdx), *zip(dws, rdws)])
    assert mean_share > 10, mean_share


def test_split_terms_add_up():
    """Three bf16 terms hold an f32 value to 2^-24 of it (the kernel's
    split arithmetic: round, subtract exactly, round the rest)."""
    gen = torch.Generator().manual_seed(14)
    v = torch.randn(4096, generator=gen) * torch.exp(4 * torch.randn(4096, generator=gen))
    terms = split_terms(v, 3)
    assert all(torch.equal(t, t.to(torch.bfloat16).float()) for t in terms)
    err = (v.double() - sum(t.double() for t in terms)).abs()
    assert bool((err <= 2.0 ** -24 * v.double().abs()).all())


def test_stream_and_partial_layout_of_the_stem():
    """The stem's weight stream: 16 forward K chunks (176, 128 x 3, 304 and
    128 packed inputs in 64-column chunks) and 36 dh chunks (9 passes of 4
    out-column chunks), within the kernel's list; a per-block partial rounds
    each dW row up to 4 floats (16-byte reductions) and keeps every db."""
    d_in, d_out, n_layers, width, skips, bias, _ = SHAPES["stem"]
    params = ParamTree(init_mlp(torch.Generator().manual_seed(0), d_in, d_out,
                                n_layers, width, skips, bias))
    _, _, per_layer, kx, h_stride, _, _ = tfm.pack_weights(params, d_in, skips)
    chunks = tfm.bwd_stream_chunks(per_layer)
    fwd = [c for c in chunks if c == 128 * (tfm._BWD_KC + tfm._PAD)]
    assert len(fwd) == 16 and len(chunks) == 52 <= tfm._BWD_MAX_CHUNKS
    assert all(c % 8 == 0 for c in chunks)  # 16-byte bulk copies
    _, per_layer_bwd, _ = tfm.bwd_layout(params, d_in, skips)
    floats = tfm.bwd_partial_floats(per_layer_bwd, True)
    assert floats == 128 * (176 + 128 * 3 + 304 + 128) + 6 * 128
    assert tfm.bwd_smem_bytes(per_layer, kx, h_stride) <= tfm._SMEM_LIMIT
