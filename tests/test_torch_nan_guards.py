"""ROADMAP C9: two ways the JAX package's training step turns non-finite,
fed to both packages forward and backward. The port must stay finite, and
equal to JAX wherever JAX is finite.

1. A density that overflows f32 (``trunc_exp`` of a logit above ~88.7 is
   inf): JAX's ``exclusive_cumsum`` is ``cumsum - x``, inf - inf = NaN at
   that sample, and the ray's weights turn NaN; the port's is the inclusive
   cumsum shifted by one. In a masked slot JAX's ``sigma * delta * mask``
   is inf * 0 = NaN; the port selects the slot away.
2. A warp that ``se3_apply`` sends to NaN (a screw axis whose squared norm
   overflows f32): JAX's guard ``where(isnan(warped), pos, warped)`` fixes
   the forward but passes NaN gradients back through ``se3_apply``; the
   port differentiates a zero screw on those rows instead.

Tolerance where both are finite: rtol 1e-5, atol 1e-6 (f32 throughout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, t, to_numpy_tree

from nersemble_tpu.config import SE3DeformationFieldConfig as JaxDeformConfig
from nersemble_tpu.models.deformation import deformation_offsets as j_offsets
from nersemble_tpu.models.deformation import init_deformation_field as j_init
from nersemble_tpu.ops.rendering import exclusive_cumsum as j_exclusive_cumsum
from nersemble_tpu.ops.rendering import render_weights as j_render_weights
from nersemble_tpu.ops.trunc_exp import trunc_exp as j_trunc_exp
from nersemble_tpu_torch.config import SE3DeformationFieldConfig
from nersemble_tpu_torch.engine.checkpoints import params_from_numpy
from nersemble_tpu_torch.models.deformation import deformation_offsets
from nersemble_tpu_torch.ops.rendering import exclusive_cumsum, render_weights
from nersemble_tpu_torch.ops.trunc_exp import trunc_exp

RTOL, ATOL = 1e-5, 1e-6
R, S = 6, 12
OVERFLOW = (2, 4)  # (ray, slot) whose density logit overflows exp in f32


def _rays():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(R, S)).astype(np.float32)
    logits[OVERFLOW] = 100.0  # exp(100) = inf in f32
    deltas = rng.uniform(0.01, 0.05, size=(R, S)).astype(np.float32)
    t_starts = np.cumsum(deltas, axis=1) - deltas + 2.0
    mask = rng.uniform(size=(R, S)) < 0.8
    mask[OVERFLOW] = True
    mask[3, 7] = False
    logits[3, 7] = 100.0  # an overflowed density in a masked slot
    cot = rng.normal(size=(R, S)).astype(np.float32)
    return logits, t_starts, t_starts + deltas, mask, cot


def _close_where_finite(ours, ref, err_msg):
    finite = np.isfinite(ref)
    assert np.isfinite(ours).all(), err_msg
    np.testing.assert_allclose(ours[finite], ref[finite], rtol=RTOL, atol=ATOL,
                               err_msg=err_msg)
    return finite


def test_exclusive_cumsum_is_the_jax_one_on_finite_inputs():
    x = np.random.default_rng(1).normal(size=(5, 9)).astype(np.float32)
    for dim in (0, 1, -1):
        np.testing.assert_allclose(n(exclusive_cumsum(t(x), dim=dim)),
                                   np.asarray(j_exclusive_cumsum(x, axis=dim)),
                                   rtol=RTOL, atol=ATOL)


def test_overflowing_density_stays_finite():
    logits, t0, t1, mask, cot = _rays()

    def j_loss(h):
        w, trans = j_render_weights(j_trunc_exp(h), t0, t1, mask)
        return jnp.sum(w * cot) + jnp.sum(trans * cot), (w, trans)

    (_, (j_w, j_trans)), j_grad = jax.value_and_grad(j_loss, has_aux=True)(logits)
    h = t(logits).requires_grad_(True)
    w, trans = render_weights(trunc_exp(h), t(t0), t(t1), t(mask))
    (torch.sum(w * t(cot)) + torch.sum(trans * t(cot))).backward()

    j_w, j_grad = np.asarray(j_w), np.asarray(j_grad)
    # the reference's fault: NaN on the overflowing ray, and on the ray whose
    # masked slot overflowed (inf * a zero mask)
    assert not np.isfinite(j_w[OVERFLOW[0]]).all() and not np.isfinite(j_w[3]).all()
    assert not np.isfinite(j_grad).all()
    finite = _close_where_finite(n(w), j_w, "weights")
    assert finite[[r for r in range(R) if r not in (OVERFLOW[0], 3)]].all()
    _close_where_finite(n(trans), np.asarray(j_trans), "transmittance")
    _close_where_finite(n(h.grad), j_grad, "d logits")
    # past the overflow the ray is opaque: no weight, no gradient
    assert (n(w)[OVERFLOW[0], OVERFLOW[1] + 1:] == 0).all()
    assert n(w)[OVERFLOW] == pytest.approx(float(n(trans)[OVERFLOW]))


@pytest.mark.parametrize("bad_rows", [(1, 4), ()], ids=["nan_rows", "finite"])
def test_nan_warp_guard_has_a_finite_backward(bad_rows):
    """Rows whose warp code is 1e25 drive the screw axis to ~1e20, whose
    squared norm overflows: se3_apply gives NaN there."""
    cfg_j, cfg_t = JaxDeformConfig(), SE3DeformationFieldConfig()
    cfg_j.mlp_num_layers = cfg_t.mlp_num_layers = 2
    cfg_j.mlp_layer_width = cfg_t.mlp_layer_width = 16
    cfg_j.warp_code_dim = cfg_t.warp_code_dim = 8
    cfg_j.skip_connections = cfg_t.skip_connections = ()
    params = to_numpy_tree(j_init(jax.random.PRNGKey(0), cfg_j))
    params["head_rv"]["w"] = params["head_rv"]["w"] * 1e3  # a visible warp
    rng = np.random.default_rng(3)
    pos = rng.uniform(0.2, 0.8, size=(7, 3)).astype(np.float32)
    code = rng.normal(size=(7, 8)).astype(np.float32)
    code[list(bad_rows)] *= 1e25
    cot = rng.normal(size=(7, 3)).astype(np.float32)

    def j_loss(p, x, c):
        off = j_offsets(p, x, c, cfg_j, window_param=None,
                        compute_dtype=jnp.float32, use_fused_mlp=False)
        return jnp.sum(off * cot), off

    (_, j_off), (j_gp, j_gx, j_gc) = jax.value_and_grad(
        j_loss, argnums=(0, 1, 2), has_aux=True)(params, pos, code)
    tparams = params_from_numpy(params, "cpu")
    for p in tparams.parameters():
        p.requires_grad_(True)
    x, c = t(pos).requires_grad_(True), t(code).requires_grad_(True)
    off = deformation_offsets(tparams, x, c, cfg_t, window_param=None,
                              compute_dtype=torch.float32)
    torch.sum(off * t(cot)).backward()

    j_off = np.asarray(j_off)
    assert np.isfinite(j_off).all()  # JAX's forward guard holds
    np.testing.assert_allclose(n(off), j_off, rtol=RTOL, atol=ATOL)
    good = [r for r in range(7) if r not in bad_rows]
    assert (j_off[list(bad_rows)] == 0).all()
    j_gx, j_gc = np.asarray(j_gx), np.asarray(j_gc)
    if bad_rows:  # the reference's fault: NaN gradients back through se3_apply
        assert not np.isfinite(j_gx[list(bad_rows)]).all()
        assert not np.isfinite(j_gp["head_rv"]["w"]).all()
    _close_where_finite(n(x.grad)[good], j_gx[good], "d positions")
    _close_where_finite(n(c.grad)[good], j_gc[good], "d warp code")
    assert np.isfinite(n(x.grad)).all() and np.isfinite(n(c.grad)).all()
    for name, g in tparams.named_parameters():
        ref = j_gp
        for part in name.split("."):
            ref = ref[int(part)] if isinstance(ref, list) else ref[part]
        _close_where_finite(n(g.grad), np.asarray(ref), f"d {name}")
