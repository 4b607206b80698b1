"""Judges the training batches the program's data pipeline drew, ray by
ray, against the capture's scene.

A ray's origin names its camera (the rig's centre, in the viewer frame,
scaled); its direction, taken back into that camera's frame, names the
pixel; its timestep names the frame. The scene is shaded again at that
pixel (``capture.expected_pixels``) and the ray's rgb, alpha and depth are
compared with what the dataset holds there. The error of a ray is the
largest of: its distance from the nearest camera centre, its pixel
position's distance from a pixel centre, and the gaps of rgb, alpha and
depth (over the scale).
"""

from typing import Dict

import numpy as np
import torch

from benchmark import capture


def batch_error(cell) -> float:
    spec, scale = cell.traffic["capture"], cell.scale
    centres, to_cam = capture.viewer_poses(spec, scale)
    ow, oh = spec["original_size"]
    k = capture.intrinsics((ow, oh))
    k[:2] /= 2
    worst = 0.0
    for batch in cell.checked["batches"]:
        b = {key: v.detach().cpu().numpy() for key, v in batch.items()}
        o = b["origins"].astype(np.float64)
        dist = np.linalg.norm(o[:, None, :] - centres[None], axis=-1)
        cam = dist.argmin(1)
        worst = max(worst, float(dist.min(1).max()) / scale)
        d = np.einsum("rij,rj->ri", to_cam[cam], b["directions"].astype(np.float64))
        x = k[0, 0] * d[:, 0] / d[:, 2] + k[0, 2] - 0.5
        y = k[1, 1] * d[:, 1] / d[:, 2] + k[1, 2] - 0.5
        xi, yi = np.rint(x), np.rint(y)
        worst = max(worst, float(np.abs(x - xi).max()), float(np.abs(y - yi).max()))
        exp = capture.expected_pixels(spec, cam, b["timesteps"].astype(np.int64),
                                      xi.astype(np.int64), yi.astype(np.int64), scale)
        for key, s in (("rgb", 1.0), ("alpha", 1.0), ("depth", scale)):
            worst = max(worst, float(np.abs(b[key] - exp[key]).max()) / s)
    return worst


def alter(batch: Dict, ray: int = 0) -> Dict:
    """``batch`` with one ray's colour changed (a fault for the tests)."""
    batch = dict(batch)
    rgb = batch["rgb"].clone()
    rgb[ray] = torch.remainder(rgb[ray] + 0.5, 1.0)
    batch["rgb"] = rgb
    return batch
