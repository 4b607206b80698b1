"""A synthetic multi-view capture on disk, in the published dataset's layout
(the port's copy of tests/synthetic_data.make_synthetic_dataset): a shaded
sphere whose centre moves over time, optionally squashed into a time-varying
ellipsoid and covered with a surface-anchored procedural texture, seen by
the 16-camera rig on two staggered elevation rings, written as images, alpha
maps, 16-bit depth maps, colour corrections and ``camera_params.json``
through utils/png.py. It drives the train CLI and the quality benchmark
where no capture ships.

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


def squash_factor(time_frac: float, amplitude: float) -> float:
    """The time-varying y squash of the ellipsoid (the non-rigid motion of
    the dynamic quality benchmark)."""
    return 1.0 - amplitude * np.sin(np.pi * time_frac)


def surface_texture(n_obj: np.ndarray, style: str = "default") -> np.ndarray:
    """Procedural multi-frequency albedo from object-space unit normals, so
    it sticks to the surface under motion and squash. ``"sharp"`` adds
    strong very-high-frequency bands (a period of ~4 pixels at the quality
    benchmark's framing): multi-view parallax of fine texture is what makes
    a field carve instead of converging to fog."""
    theta = np.arctan2(n_obj[..., 1], n_obj[..., 0])
    phi = np.arccos(np.clip(n_obj[..., 2], -1.0, 1.0))
    t1 = np.sin(9.0 * theta) * np.sin(9.0 * phi)
    t2 = np.sin(23.0 * theta + 1.3) * np.sin(17.0 * phi + 0.7)
    t3 = np.sin(5.0 * theta - 2.1) * np.cos(7.0 * phi)
    r = 0.55 + 0.35 * t1 + 0.10 * t2
    g = 0.45 + 0.30 * t3 - 0.15 * t1
    b = 0.50 + 0.25 * t2 + 0.15 * t3
    rgb = np.stack([r, g, b], axis=-1)
    if style == "sharp":
        s1 = np.sin(81.0 * theta + 0.4) * np.sin(67.0 * phi + 1.9)
        s2 = np.sign(np.sin(41.0 * theta) * np.sin(37.0 * phi + 0.5))
        rgb = rgb + (0.22 * s1 + 0.13 * s2)[..., None]
    return np.clip(rgb, 0.0, 1.0)


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
                height: int, time_frac: float, texture: bool = False,
                squash: float = 0.0, texture_style: str = "default"):
    """Analytic render -> (rgb u8 [H,W,3], alpha u8 [H,W], depth f32 [H,W]).
    The ray meets the unit sphere of object space: translated to the centre
    and with y scaled by 1 / ``squash_factor``."""
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
    s = np.array([1.0, squash_factor(time_frac, squash), 1.0])
    oc = (origin - center) / s
    d_obj = dirs / s
    a = (d_obj * d_obj).sum(-1)
    b = (d_obj * oc).sum(-1)
    c = (oc * oc).sum() - SPHERE_RADIUS ** 2
    disc = b * b - a * c
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / np.maximum(a, 1e-12)
    hit = (disc > 0) & (t > 0)
    depth = np.where(hit, t, 0.0).astype(np.float32)
    points = origin + dirs * t[..., None]
    n_obj = ((points - center) / s) / SPHERE_RADIUS
    n_obj = n_obj / np.maximum(np.linalg.norm(n_obj, axis=-1, keepdims=True), 1e-12)
    # the ellipsoid's world normal is normalize(n_obj / s)
    normals = n_obj / s
    normals = normals / np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True),
                                   1e-12)
    light = np.array([0.5, -0.7, 0.5]) / np.linalg.norm([0.5, -0.7, 0.5])
    shade = np.clip((normals * light).sum(-1), 0.0, 1.0) * 0.7 + 0.3
    albedo = surface_texture(n_obj, texture_style) if texture else SPHERE_COLOR
    rgb = np.where(hit[..., None], albedo * shade[..., None], 0.0)
    rgb_u8 = (np.clip(rgb, 0, 1) * 255).round().astype(np.uint8)
    alpha_u8 = np.where(hit, 255, 0).astype(np.uint8)
    return rgb_u8, alpha_u8, depth


def make_synthetic_dataset(root, participant_id: int = 30,
                           sequence_name: str = "SYN-1",
                           n_timesteps: int = 3,
                           original_size: Tuple[int, int] = (64, 88),
                           n_cams: int = 16,
                           texture: bool = False,
                           squash: float = 0.0,
                           texture_style: str = "default") -> dict:
    """Write the capture under ``root`` with images at half of
    ``original_size`` (width, height), the dataset's 2x downscale, rendered
    by ``render_view`` with ``texture``, ``squash`` and ``texture_style``;
    returns its sizes, poses and intrinsics."""
    root = Path(root)
    ow, oh = original_size
    w, h = ow // 2, oh // 2
    intrinsics_full = np.array([[ow * 1.2, 0, ow / 2],
                                [0, ow * 1.2, oh / 2],
                                [0, 0, 1.0]])
    intrinsics_half = intrinsics_full.copy()
    intrinsics_half[:2] /= 2
    poses = camera_rig(n_cams)
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
            rgb, alpha, depth = render_view(w2c, intrinsics_half, w, h, time_frac,
                                            texture=texture, squash=squash,
                                            texture_style=texture_style)
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


def write_capture(root, participant_id: int = 30, sequence_name: str = "SYN-1",
                  n_timesteps: int = 3,
                  original_size: Tuple[int, int] = (1100, 1604)) -> dict:
    """The untextured capture at the flagship's image size (550x802 on
    disk): ``make_synthetic_dataset`` with another default size."""
    return make_synthetic_dataset(root, participant_id, sequence_name,
                                  n_timesteps, original_size)
