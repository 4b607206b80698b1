"""A synthetic multi-view capture on disk, in the published dataset's layout
(the port's copy of tests/synthetic_data.make_synthetic_dataset without
its textures): a shaded sphere whose centre moves over time, seen by the
16-camera rig on two staggered elevation rings, written as images, alpha
maps, 16-bit depth maps, colour corrections and ``camera_params.json``
through utils/png.py. It drives the train CLI where no capture ships.

Geometry lives in the calibration (OpenCV-world) frame at metric scale; the
dataparser's x9 world scaling is a pure rescale invisible to the cameras.
"""

import json
from pathlib import Path
from typing import Tuple

import numpy as np

from nersemble_tpu_torch.constants import SERIALS
from nersemble_tpu_torch.utils import png
from nersemble_tpu_torch.utils.quantization import DepthQuantizer

SPHERE_RADIUS = 0.15
CAM_DISTANCE = 1.0
SPHERE_COLOR = np.array([0.8, 0.35, 0.25])


def sphere_center(time_frac: float) -> np.ndarray:
    """The centre moves along calibration x with time."""
    return np.array([0.06 * time_frac - 0.03, 0.0, 0.0])


def camera_rig(n_cams: int = 16, elevation_deg: float = 22.5) -> dict:
    """serial -> OpenCV world_2_cam [4, 4]: cameras alternate between a lower
    and an upper ring (y = down), the rings' azimuths staggered by half a
    slot, all looking at the origin."""
    poses = {}
    el = np.deg2rad(elevation_deg)
    per_ring = n_cams // 2
    for i in range(n_cams):
        ring = i % 2
        az = 2 * np.pi * (i // 2) / per_ring + ring * np.pi / per_ring
        y_comp = np.sin(el) * (1.0 if ring == 0 else -1.0)
        position = CAM_DISTANCE * np.array([
            np.cos(el) * np.sin(az), y_comp, np.cos(el) * np.cos(az)])
        z = -position / np.linalg.norm(position)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, position
        poses[SERIALS[i]] = np.linalg.inv(c2w)
    return poses


def render_view(w2c: np.ndarray, intrinsics: np.ndarray, width: int,
                height: int, time_frac: float):
    """Analytic render -> (rgb u8 [H,W,3], alpha u8 [H,W], depth f32 [H,W])."""
    c2w = np.linalg.inv(w2c)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    dirs_cam = np.stack([(xs + 0.5 - cx) / fx, (ys + 0.5 - cy) / fy,
                         np.ones_like(xs, float)], axis=-1)
    dirs = dirs_cam @ c2w[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origin = c2w[:3, 3]
    center = sphere_center(time_frac)
    oc = origin - center
    b = (dirs * oc).sum(-1)
    c = (oc * oc).sum() - SPHERE_RADIUS ** 2
    disc = b * b - c
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit = (disc > 0) & (t > 0)
    depth = np.where(hit, t, 0.0).astype(np.float32)
    normals = (origin + dirs * t[..., None] - center) / SPHERE_RADIUS
    light = np.array([0.5, -0.7, 0.5]) / np.linalg.norm([0.5, -0.7, 0.5])
    shade = np.clip((normals * light).sum(-1), 0.0, 1.0) * 0.7 + 0.3
    rgb = np.where(hit[..., None], SPHERE_COLOR * shade[..., None], 0.0)
    rgb_u8 = (np.clip(rgb, 0, 1) * 255).round().astype(np.uint8)
    alpha_u8 = np.where(hit, 255, 0).astype(np.uint8)
    return rgb_u8, alpha_u8, depth


def write_capture(root, participant_id: int = 30, sequence_name: str = "SYN-1",
                  n_timesteps: int = 3,
                  original_size: Tuple[int, int] = (1100, 1604)) -> dict:
    """Write the capture under ``root`` with images at half of
    ``original_size`` (width, height), the dataset's 2x downscale; returns
    its sizes and poses."""
    root = Path(root)
    ow, oh = original_size
    w, h = ow // 2, oh // 2
    intrinsics_full = np.array([[ow * 1.2, 0, ow / 2],
                                [0, ow * 1.2, oh / 2],
                                [0, 0, 1.0]])
    intrinsics_half = intrinsics_full.copy()
    intrinsics_half[:2] /= 2
    poses = camera_rig()
    participant = root / f"{participant_id:03d}"
    seq = participant / "sequences" / sequence_name
    quantizer = DepthQuantizer()
    for t in range(n_timesteps):
        time_frac = t / max(n_timesteps - 1, 1)
        frame = seq / f"frame_{t:05d}"
        img_dir = frame / "images-2x-73fps"
        alpha_dir = frame / "alpha_map-73fps"
        depth_dir = frame / "colmap-73fps" / "depth_maps_compressed"
        for d in (img_dir, alpha_dir, depth_dir):
            d.mkdir(parents=True, exist_ok=True)
        for serial, w2c in poses.items():
            rgb, alpha, depth = render_view(w2c, intrinsics_half, w, h, time_frac)
            png.imwrite(img_dir / f"cam_{serial}.png", rgb)
            png.imwrite(alpha_dir / f"cam_{serial}.png", alpha)
            png.imwrite(depth_dir / f"cam_{serial}.png", quantizer.encode(depth))
    cc_dir = participant / "annotations" / sequence_name / "color_correction"
    cc_dir.mkdir(parents=True, exist_ok=True)
    identity = np.hstack([np.eye(3), np.zeros((3, 1))])
    for serial in poses:
        np.save(cc_dir / f"{serial}.npy", identity)
    with open(participant / "camera_params.json", "w") as f:
        json.dump({"world_2_cam": {s: m.tolist() for s, m in poses.items()},
                   "intrinsics": intrinsics_full.tolist()}, f)
    return {"original_size": (ow, oh), "image_size": (w, h),
            "intrinsics_full": intrinsics_full, "poses": poses,
            "n_timesteps": n_timesteps}
