"""Vendored FovVideoVDP-class perceptual video metric (JOD scale); the
port's copy of nersemble_tpu/utils/fvvdp.py, numpy + scipy on the host.

Reference use: scripts/evaluate/evaluate_nersemble.py:48,206-240 scores each
camera's rendered frame stack against ground truth with
``pyfvvdp.fvvdp(display_name='standard_4k').predict(..., dim_order='FHWC')``
and stores the JOD (just-objectionable-difference, 10 = identical) in
``evaluation_result.json``.

pyfvvdp is not installed in this image and cannot be fetched (zero egress),
so this module vendors the COMPUTE PIPELINE of FovVideoVDP (Mantiuk et al.,
SIGGRAPH 2021) from the published description:

  display photometry (sRGB EOTF -> cd/m^2) -> pixels-per-degree geometry ->
  sustained + transient temporal channels (FIR filters) -> Laplacian pyramid
  per channel -> local-adaptation Weber contrast -> CSF-weighted difference
  with mutual masking -> Minkowski pooling over space/bands/channels/frames
  -> JOD regression.

CALIBRATION CAVEAT (documented in STATUS.md): pyfvvdp's fitted parameter
files (fvvdp_parameters.json: psychophysically calibrated CSF fits, masking
exponents and the JOD regression) are not available offline. This module
uses the PUBLISHED Barten-approximation CSF (Watson & Ahumada's formulation
of spatio-luminance sensitivity) plus the paper's pipeline constants where
published. The JOD regression is fitted by scripts/calibrate_jod.py against
the reference's one published (distortion -> JOD) anchor — official metrics
PSNR 31.48 <-> JOD 7.85 (reference README.md:159-166) — with targets linear
in PSNR through it at the paper's baseline-table slope (~0.2 JOD/dB), on a
blur+noise series (identical -> 10.0; PSNR-31.5-class renders -> ~7.9-8.1;
pinned by tests/test_fvvdp.py::test_jod_calibration_anchor). Scores are
comparable BETWEEN models evaluated by this framework and now land on the
reference's scale for render-like distortions, but exact agreement with
pyfvvdp's absolute numbers is not guaranteed. When pyfvvdp IS importable it
is always preferred (utils/jod.py resolution order).

The implementation is numpy + scipy (host, eval-only), deliberately
dependency-light.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np


def gaussian_filter(*args, **kwargs):
    """scipy.ndimage.gaussian_filter, imported at first use (eval-only,
    like the occupancy CC filter)."""
    from scipy.ndimage import gaussian_filter as impl
    return impl(*args, **kwargs)


@dataclass(frozen=True)
class DisplayModel:
    """Photometry + geometry of the assumed display.

    ``standard_4k`` mirrors pyfvvdp's registry entry: a 30-inch 3840x2160
    panel viewed from 0.6 m, 300 cd/m^2 peak, 1000:1 contrast.
    """

    width: int = 3840
    height: int = 2160
    diagonal_inches: float = 30.0
    distance_m: float = 0.6
    peak_luminance: float = 300.0
    contrast: float = 1000.0

    def pixels_per_degree(self) -> float:
        ar = self.width / self.height
        height_m = 0.0254 * self.diagonal_inches / np.sqrt(1 + ar * ar)
        pix_m = height_m / self.height
        return 1.0 / np.degrees(2 * np.arctan(0.5 * pix_m / self.distance_m))

    def to_luminance(self, srgb01: np.ndarray) -> np.ndarray:
        """[..., 3] or [...] sRGB in [0,1] -> luminance in cd/m^2."""
        v = np.clip(srgb01, 0.0, 1.0)
        linear = np.where(v <= 0.04045, v / 12.92,
                          ((v + 0.055) / 1.055) ** 2.4)
        if linear.ndim and linear.shape[-1] == 3:
            linear = (0.2126 * linear[..., 0] + 0.7152 * linear[..., 1]
                      + 0.0722 * linear[..., 2])
        black = self.peak_luminance / self.contrast
        return black + (self.peak_luminance - black) * linear


def _csf_sensitivity(rho_cpd: float, luminance: np.ndarray,
                     transient: bool) -> np.ndarray:
    """Spatio-luminance contrast sensitivity (published Barten approximation).

    S(rho, L) after Barten (1999) in the simplified form used by many VDP
    implementations; the transient channel re-uses the sustained CSF shifted
    toward low frequencies (FovVideoVDP models the transient channel as most
    sensitive around ~0.5-2 cpd) and scaled down.
    """
    rho = max(rho_cpd, 0.125)
    if transient:
        rho = max(rho, 0.5) * 4.0  # shift: transient peaks at lower freqs
    L = np.maximum(luminance, 1e-3)
    # Barten's formula (approximate, published constants)
    num = 5200.0 * np.exp(-0.0016 * rho * rho * (1 + 100.0 / L) ** 0.08)
    den = np.sqrt((1 + 144.0 / 60.0 + 0.64 * rho * rho)
                  * (63.0 / L ** 0.83 + 1.0 / (1 - np.exp(-0.02 * rho * rho))))
    s = num / den
    if transient:
        s = 0.25 * s
    return s


def _gauss_pyramid(img: np.ndarray, n_levels: int):
    levels = [img]
    for _ in range(n_levels - 1):
        blurred = gaussian_filter(levels[-1], 1.0, mode="nearest")
        levels.append(blurred[::2, ::2])
    return levels


def _laplacian_pyramid(img: np.ndarray, n_levels: int):
    gp = _gauss_pyramid(img, n_levels)
    lp = []
    for i in range(n_levels - 1):
        h, w = gp[i].shape
        up = np.repeat(np.repeat(gp[i + 1], 2, axis=0), 2, axis=1)[:h, :w]
        up = gaussian_filter(up, 1.0, mode="nearest")
        lp.append(gp[i] - up)
    lp.append(gp[-1])
    return lp, gp


def _temporal_channels(lum: np.ndarray, fps: float):
    """[T, H, W] luminance -> (sustained [T,H,W], transient [T,H,W]).

    Sustained: low-pass FIR (~150 ms Gaussian); transient: the residual
    band-pass (paper: sustained/transient decomposition of the temporal
    signal). Single frames (image mode) get transient = 0 like pyfvvdp.
    """
    T = lum.shape[0]
    if T < 3:
        return lum, np.zeros_like(lum)
    sigma_frames = max(0.150 * fps, 0.5)
    radius = int(np.ceil(3 * sigma_frames))
    t = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (t / sigma_frames) ** 2)
    k /= k.sum()
    pad = np.concatenate([lum[:1].repeat(radius, 0), lum,
                          lum[-1:].repeat(radius, 0)], axis=0)
    sustained = np.zeros_like(lum)
    for i in range(T):
        window = pad[i:i + 2 * radius + 1]
        sustained[i] = np.tensordot(k, window, axes=(0, 0))
    return sustained, lum - sustained


@dataclass(frozen=True)
class FvvdpParameters:
    """Pipeline constants. Published pipeline structure; the masking
    exponents follow the paper's transducer form, the JOD regression is
    coarsely calibrated on synthetic distortions (see module docstring)."""

    mask_p: float = 2.2       # excitation exponent
    mask_q: float = 2.0       # inhibition (masking) exponent
    beta_space: float = 3.0   # Minkowski over pixels
    beta_band: float = 3.0    # over pyramid bands
    beta_tch: float = 2.0     # over temporal channels
    beta_frame: float = 2.0   # over frames
    # JOD regression fitted by scripts/calibrate_jod.py against the one HARD
    # published anchor — the reference's official PSNR 31.48 <-> JOD 7.85
    # pair (reference README.md:159-166) — plus targets linear in PSNR
    # through it at ~0.2 JOD/dB (the NeRSemble paper's baseline-table slope)
    # on a blur+noise series over a textured synthetic head stack. Puts a
    # PSNR-31.5-class render at JOD ~7.9-8.1 (was 2.75 pre-calibration).
    jod_a: float = 23.08      # JOD regression scale
    jod_exp: float = 0.417    # JOD regression exponent
    n_pyramid_levels: int = 6
    sensitivity_correction: float = 0.005  # global CSF scale (calibration)


class VendoredFovVideoVDP:
    """Drop-in for ``pyfvvdp.fvvdp`` within this framework's usage surface
    (``predict(test, ref, dim_order='FHWC', frames_per_second=...)``)."""

    def __init__(self, display: Optional[DisplayModel] = None,
                 params: Optional[FvvdpParameters] = None):
        import scipy.ndimage  # noqa: F401  (raises ImportError without scipy)
        self.display = display or DisplayModel()
        self.params = params or FvvdpParameters()

    vendored = True  # marker for evaluation metadata / tests

    def predict(self, test: np.ndarray, ref: np.ndarray,
                dim_order: str = "FHWC", frames_per_second: float = 30.0):
        assert dim_order == "FHWC", "only FHWC stacks are supported"
        assert test.shape == ref.shape and test.ndim == 4
        p = self.params
        if test.dtype == np.uint8:
            test = test.astype(np.float32) / 255.0
            ref = ref.astype(np.float32) / 255.0

        lum_t = self.display.to_luminance(test)
        lum_r = self.display.to_luminance(ref)
        fps = max(frames_per_second, 4.1)
        sus_t, tra_t = _temporal_channels(lum_t, fps)
        sus_r, tra_r = _temporal_channels(lum_r, fps)

        ppd = self.display.pixels_per_degree()
        T, H, W = lum_t.shape
        n_levels = min(p.n_pyramid_levels,
                       int(np.log2(max(min(H, W), 8))) - 1)
        n_levels = max(n_levels, 2)

        frame_scores = []
        for f in range(T):
            channel_scores = []
            for transient, (ct, cr) in ((False, (sus_t[f], sus_r[f])),
                                        (True, (tra_t[f], tra_r[f]))):
                if transient and T < 3:
                    continue
                lp_t, _ = _laplacian_pyramid(ct, n_levels)
                lp_r, gp_r = _laplacian_pyramid(cr, n_levels)
                # adaptation luminance per band: the REFERENCE gaussian
                # pyramid (test-agnostic adaptation)
                adapt = gp_r if not transient \
                    else _gauss_pyramid(sus_r[f], n_levels)
                band_scores = []
                for lvl in range(n_levels):
                    rho = ppd / (2.0 ** (lvl + 1)) / 2.0  # cycles/degree
                    la = np.maximum(np.abs(adapt[min(lvl, len(adapt) - 1)]),
                                    1e-3)
                    c_t = lp_t[lvl] / la
                    c_r = lp_r[lvl] / la
                    S = _csf_sensitivity(rho, la, transient) \
                        * p.sensitivity_correction
                    diff = np.abs(S * (c_t - c_r)) ** p.mask_p
                    mask = np.abs(S * np.minimum(np.abs(c_t),
                                                 np.abs(c_r))) ** p.mask_q
                    D = diff / (1.0 + mask)
                    band_scores.append(
                        np.mean(D ** p.beta_space) ** (1.0 / p.beta_space))
                bands = np.asarray(band_scores)
                channel_scores.append(
                    np.mean(bands ** p.beta_band) ** (1.0 / p.beta_band))
            ch = np.asarray(channel_scores)
            frame_scores.append(
                np.mean(ch ** p.beta_tch) ** (1.0 / p.beta_tch))
        frames = np.asarray(frame_scores)
        Q = np.mean(frames ** p.beta_frame) ** (1.0 / p.beta_frame)
        jod = 10.0 - p.jod_a * float(Q) ** p.jod_exp
        return np.float32(max(jod, 0.0)), None
