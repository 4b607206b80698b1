"""The port's image metrics and colormaps against the JAX package's:
PSNR, SSIM and MSE within 1e-5 (identical images included; in the f32
cancellation case of tests/test_metrics_golden.py both are held to SSIM's
bound instead), the masked bundle, the uint8 alpha blend bit-exact, LPIPS
absent without weights and computed with them (held to the JAX package in
tests/test_torch_serve.py), and the colormap tables equal to matplotlib's."""

import os

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from torch_parity import REPO  # noqa: F401  (puts the repo root on sys.path)

from nersemble_tpu.utils import colormaps as JC
from nersemble_tpu.utils import metrics as JM
from nersemble_tpu_torch.utils import colormaps as TC
from nersemble_tpu_torch.utils import metrics as TM

TOL = 1e-5


def _pair(seed: int, shape=(40, 52, 3), noise=0.08):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(size=shape).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("seed,shape,noise", [(0, (40, 52, 3), 0.08),
                                              (1, (11, 11, 3), 0.3),
                                              (2, (64, 33, 3), 0.01),
                                              (3, (24, 30, 1), 0.1)])
def test_psnr_ssim_mse_match_jax(seed, shape, noise):
    pred, gt = _pair(seed, shape, noise)
    p, g = torch.from_numpy(pred), torch.from_numpy(gt)
    assert float(TM.psnr(p, g)) == pytest.approx(float(JM.psnr(jnp.asarray(pred), jnp.asarray(gt))), abs=1e-4)
    assert float(TM.mse(p, g)) == pytest.approx(float(JM.mse(jnp.asarray(pred), jnp.asarray(gt))), abs=TOL)
    assert float(TM.ssim(p, g)) == pytest.approx(float(JM.ssim(jnp.asarray(pred), jnp.asarray(gt))), abs=TOL)


def test_ssim_of_identical_images_is_one():
    img = np.random.default_rng(3).uniform(size=(32, 32, 3)).astype(np.float32)
    t = torch.from_numpy(img)
    assert float(TM.ssim(t, t)) == pytest.approx(1.0, abs=TOL)
    assert float(TM.ssim(t, t)) == pytest.approx(float(JM.ssim(jnp.asarray(img), jnp.asarray(img))), abs=TOL)


def test_ssim_never_exceeds_one_under_cancellation():
    """tests/test_metrics_golden.py's flat image at amplitude 37 with 1e-3
    noise: the projected moments keep SSIM in [0.5, 1], as in JAX. Here
    f32 ``mu_xx - mu_x**2`` is rounding noise of the size of ulp(1369),
    ~1e-4, against c2 = 9e-4, so the value depends on the order in which
    each convolution sums (JAX's XLA convolution gives 0.921 here, torch's
    0.812). No 1e-5 agreement is possible in this regime; both packages
    hold the bound."""
    rng = np.random.default_rng(4)
    flat = np.full((64, 64, 3), 37.0, np.float32)
    noisy = flat + rng.normal(0, 1e-3, flat.shape).astype(np.float32)
    ours = float(TM.ssim(torch.from_numpy(flat), torch.from_numpy(noisy)))
    theirs = float(JM.ssim(jnp.asarray(flat), jnp.asarray(noisy)))
    for value in (ours, theirs):
        assert 0.5 <= value <= 1.0 + 1e-6, (ours, theirs)


@pytest.mark.parametrize("with_alpha", [False, True])
def test_image_metrics_bundle_matches(with_alpha):
    pred, gt = _pair(5)
    alpha = np.random.default_rng(6).uniform(size=gt.shape[:2]).astype(np.float32) \
        if with_alpha else None
    ours = TM.image_metrics(pred, gt, alpha, "cpu")
    theirs = JM.image_metrics(pred, gt, alpha)
    for o, t in zip(ours, theirs):
        assert o.keys() == t.keys()
        for key in o:
            if t[key] is None:
                assert o[key] is None, key
            else:
                assert o[key] == pytest.approx(t[key], abs=1e-4 if key == "psnr" else TOL), key


def test_alpha_mask_and_blend_match():
    rng = np.random.default_rng(7)
    image = rng.uniform(size=(9, 13, 3)).astype(np.float32)
    alpha = rng.uniform(size=(9, 13)).astype(np.float32)
    assert np.array_equal(TM.apply_alpha_mask(image, alpha), JM.apply_alpha_mask(image, alpha))
    image8 = rng.integers(0, 256, (2, 9, 13, 3)).astype(np.uint8)
    alpha8 = rng.integers(0, 256, (2, 9, 13)).astype(np.uint8)
    out = TM.perform_alpha_blending(image8, alpha8)
    assert out.dtype == np.uint8 and np.array_equal(out, JM.perform_alpha_blending(image8, alpha8))


def test_lpips_is_none_without_weights_and_raises_with_them(tmp_path, monkeypatch):
    """None without weights; with a weights file LPIPS is computed (it no
    longer raises), on the device the caller names: here 0 for identical
    images under one-tap weights, with the default device the card."""
    from nersemble_tpu_torch.utils import lpips
    monkeypatch.delenv("NERSEMBLE_LPIPS_WEIGHTS", raising=False)
    lpips.reset_lpips_cache()
    img = np.zeros((16, 16, 3), np.float32)
    assert TM.lpips_or_none(img, img) is None
    weights = tmp_path / "vgg.npz"
    rng = np.random.default_rng(0)
    layers = {f"features.{i}.weight": rng.normal(0, 0.1, (8, c, 3, 3)).astype(np.float32)
              for i, c in ((0, 3), (2, 8), (5, 8), (7, 8), (10, 8), (12, 8), (14, 8),
                           (17, 8), (19, 8), (21, 8), (24, 8), (26, 8), (28, 8))}
    layers.update({k.replace("weight", "bias"): np.zeros(8, np.float32) for k in list(layers)})
    layers.update({f"lin{k}.model.1.weight": np.full((1, 8, 1, 1), 0.1, np.float32)
                   for k in range(5)})
    np.savez(weights, **layers)
    monkeypatch.setenv("NERSEMBLE_LPIPS_WEIGHTS", str(weights))
    assert os.path.exists(os.environ["NERSEMBLE_LPIPS_WEIGHTS"])
    lpips.reset_lpips_cache()  # the weights are read once per process
    try:
        regular, _ = TM.image_metrics(img, img, None, "cpu")
        assert regular["lpips"] == 0.0
        other = np.full((16, 16, 3), 0.5, np.float32)
        assert TM.lpips_or_none(img + rng.uniform(size=img.shape).astype(np.float32),
                                other, "cpu") > 0
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.image_metrics(img, img)
    finally:
        lpips.reset_lpips_cache()


@pytest.mark.parametrize("cmap", ["viridis", "turbo"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_colormaps_equal_matplotlibs(cmap, dtype):
    rng = np.random.default_rng(8)
    edges = np.array([0.0, 1.0, 1.0 / 256, 255.0 / 256, 0.5, -0.2, 1.7, np.nan])
    values = np.concatenate([rng.uniform(size=200), edges]).astype(dtype).reshape(13, 16)
    ours = TC.apply_colormap(values, cmap)
    theirs = JC.apply_colormap(values, cmap)
    assert ours.dtype == theirs.dtype == np.float32
    assert np.array_equal(ours, theirs)
    table = matplotlib.colormaps[cmap](np.arange(256))[:, :3]
    assert np.array_equal(TC._TABLES[cmap], table)


def test_derived_colormaps_match():
    rng = np.random.default_rng(9)
    depth = rng.uniform(7, 10, (12, 14, 1)).astype(np.float32)
    acc = rng.uniform(size=(12, 14, 1)).astype(np.float32)
    pred, gt = _pair(10, (12, 14, 3))
    flow = rng.normal(size=(12, 14, 3)).astype(np.float32)
    assert np.array_equal(TC.apply_depth_colormap(depth, acc),
                          JC.apply_depth_colormap(depth, acc))
    assert np.array_equal(TC.apply_depth_colormap(depth, near=7.2, far=9.6),
                          JC.apply_depth_colormap(depth, near=7.2, far=9.6))
    assert np.array_equal(TC.apply_error_colormap(pred, gt), JC.apply_error_colormap(pred, gt))
    assert np.array_equal(TC.apply_scene_flow_colormap(flow), JC.apply_scene_flow_colormap(flow))
