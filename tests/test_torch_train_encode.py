"""The blended encode's backward: the port's analytic autograd Function vs
``jax.vjp`` of the JAX package's ``hash_encode_blended`` (its custom VJP),
on the quad table, the code and the positions, plus the hot-entry check of
the table-gradient accumulation.

f32: the two compute the same expressions in other summation orders, held
to rtol 1e-5 with an atol of 1e-5 of the largest value (near-zero entries
lose their relative precision to cancellation).

bf16: both round to the table dtype at the same points (the CG and BH
residuals, gbar before the BH product, the row gradient and its product
with the code), so the output and the code and position gradients agree to
rtol 1e-4 (f32 sums of the same rounded terms in other orders), and the
dense levels of the table gradient to 2 bf16 ulps (both accumulate them in
f32 and round once; another order can round to the neighbour). The hashed levels of
the table gradient differ: JAX adds their rows in bf16 (each add rounds to
8 mantissa bits), the port in f32 with one rounding at the end. An entry
that receives k rows therefore differs by at most about k bf16 ulps of the
sum of |rows| it received; the test checks 2^-8 * k * sum|rows| per entry,
computed from an f64 scatter of the rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, t

from nersemble_tpu.ops import hash_encoding as jhe
from nersemble_tpu_torch.ops import hash_encoding as the

LEVELS = (6, 10, 4, 1.5)  # dense and 1024-row hashed levels (tests/test_ops.py)
H, FL = 8, 2


def _case(dtype, n_samples, hot=False, seed=0):
    lv, ours_lv = jhe.HashGridLevels.create(*LEVELS), the.HashGridLevels.create(*LEVELS)
    rng = np.random.default_rng(seed)
    quad = rng.normal(size=(lv.total_entries, 4 * H * FL)).astype(np.float32)
    x = rng.uniform(size=(n_samples, 3)).astype(np.float32)
    if hot:  # every sample in one small region: coarse entries get ~N rows
        x = (0.3 + 0.02 * x).astype(np.float32)
    code = rng.normal(size=(n_samples, H)).astype(np.float32)
    gbar = rng.normal(size=(n_samples, lv.n_levels * FL)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    out, vjp = jax.vjp(lambda q, xx, c: jhe.hash_encode_blended(q, xx, c, lv, FL),
                       jnp.asarray(quad).astype(jdt), jnp.asarray(x),
                       jnp.asarray(code))
    theirs = (out,) + vjp(jnp.asarray(gbar))
    qt = t(quad).to(getattr(torch, dtype)).requires_grad_(True)
    xt, ct = t(x).requires_grad_(True), t(code).requires_grad_(True)
    ours_out = the.hash_encode_blended(qt, xt, ct, ours_lv, FL)
    ours_out.backward(t(gbar))
    ours = (ours_out, qt.grad, xt.grad, ct.grad)
    return ours, theirs, lv, (quad, x, code, gbar)


def _close(a, b, what, rtol=1e-5):
    a, b = n(a).astype(np.float32), n(b).astype(np.float32)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-5 * np.abs(b).max(),
                               err_msg=what)


def test_encode_backward_matches_jax_f32():
    ours, theirs, _, _ = _case("float32", 500)
    for what, a, b in zip(("out", "d_table", "d_x", "d_code"), ours, theirs):
        assert np.abs(n(b)).max() > 0, what
        _close(a, b, what)


def _row_mass(lv, inputs):
    """Per table element: (number of scattered rows, f64 sum of |row|),
    the rows being the analytic row gradient wy * u_q * code_h * gbar."""
    quad, x, code, gbar = inputs
    idx, wy, fx, fz = (np.asarray(a, np.float64)
                       for a in jhe.hash_grid_indices(jnp.asarray(x), lv))
    N, L = x.shape[0], lv.n_levels
    u = np.stack([(1 - fx) * (1 - fz), (1 - fx) * fz, fx * (1 - fz), fx * fz], -1)
    rows = (wy.reshape(N, 2, L)[:, :, :, None, None, None]
            * u[:, None, :, :, None, None]
            * code[:, None, None, None, :, None]
            * gbar.reshape(N, 1, L, 1, 1, FL))  # [N, 2, L, 4, H, FL]
    mass = np.zeros(quad.shape)
    count = np.zeros(quad.shape[0])
    np.add.at(mass, idx.astype(np.int64).reshape(-1),
              np.abs(rows).reshape(N * 2 * L, -1))
    np.add.at(count, idx.astype(np.int64).reshape(-1), 1)
    return count, mass


def test_encode_backward_matches_jax_bf16():
    ours, theirs, lv, inputs = _case("bfloat16", 3000, seed=1)
    _close(ours[0], theirs[0], "out", rtol=1e-4)
    _close(ours[2], theirs[2], "d_x", rtol=1e-4)
    _close(ours[3], theirs[3], "d_code", rtol=1e-4)
    d_ours, d_theirs = n(ours[1].float()), np.asarray(theirs[1], np.float32)
    dense, e_dense = jhe.dense_split(lv)
    assert 0 < dense < lv.n_levels
    # dense prefix: f32 accumulation in both, one rounding to bf16
    np.testing.assert_allclose(d_ours[:e_dense], d_theirs[:e_dense],
                               rtol=2 ** -7, atol=1e-6 * np.abs(d_theirs).max())
    count, mass = _row_mass(lv, inputs)
    hashed = slice(e_dense, None)
    assert count[hashed].max() >= 4  # entries that sum several rows
    bound = 2.0 ** -8 * np.maximum(count[hashed], 1)[:, None] * mass[hashed]
    diff = np.abs(d_ours[hashed] - d_theirs[hashed])
    assert (diff <= bound + 1e-30).all(), float((diff / (bound + 1e-30)).max())
    assert (diff > 0).any()  # the accumulations really differ there


def test_hot_entry_gradient_mass_matches_f32_oracle():
    """All samples in one small region: the coarse (dense) entries receive
    thousands of rows each. The port's bf16-table gradient keeps the mass of
    an f32 oracle (the JAX reference formulation under autodiff) to 1% on
    the dense and on the hashed levels, where a bf16 accumulation saturates
    (ROADMAP C4)."""
    lv, ours_lv = jhe.HashGridLevels.create(*LEVELS), the.HashGridLevels.create(*LEVELS)
    _, e_dense = jhe.dense_split(lv)
    rng = np.random.default_rng(2)
    N = 8192
    x = (0.3 + 0.02 * rng.uniform(size=(N, 3))).astype(np.float32)
    code = rng.uniform(size=(N, H)).astype(np.float32)
    table = rng.uniform(-1e-4, 1e-4, (lv.total_entries, H * FL)).astype(np.float32)
    quad32 = jhe.build_quad_table(jnp.asarray(table), lv, dtype=jnp.float32)
    oracle = np.asarray(jax.grad(lambda q: jnp.sum(
        jhe.hash_encode_blended_reference(q, jnp.asarray(x), jnp.asarray(code),
                                          lv, FL)))(quad32))
    qt = t(np.asarray(quad32)).to(torch.bfloat16).requires_grad_(True)
    the.hash_encode_blended(qt, t(x), t(code), ours_lv, FL).sum().backward()
    ours = n(qt.grad.float())
    for part in (slice(None, e_dense), slice(e_dense, None)):
        m32, m16 = np.abs(oracle[part]).sum(), np.abs(ours[part]).sum()
        assert m32 > 0
        assert abs(m16 / m32 - 1.0) < 0.01, (m16, m32)
