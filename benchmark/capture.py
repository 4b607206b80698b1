"""The synthetic multi-view capture that the training cells read, and the
pixel values it holds.

A copy, kept with the benchmark, of the port's scene generator
(``utils/synthetic_capture.py``): a shaded sphere whose centre moves along
calibration x over time, seen by a 16-camera rig on two staggered
elevation rings, written in the published dataset's layout (images, alpha
maps, 16-bit depth maps, colour corrections, ``camera_params.json``). The
benchmark writes it once per checkout into a fixed folder; the port's data
pipeline reads it from there. ``expected_pixels`` recomputes, from the
scene alone, what any pixel of the capture holds after the dataset's
decoding, so that the training batches the port draws can be judged ray by
ray (``reference/batch_check.py``).
"""

import json
import os
import struct
import zlib
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

SERIALS = [
    "222200042", "222200044", "222200046", "222200040",
    "222200036", "222200048", "220700191", "222200041",
    "222200037", "222200038", "222200047", "222200043",
    "222200049", "222200039", "222200045", "221501007",
]
TRAIN_CAM_IDS = [8, 7, 9, 4, 10, 5, 13, 2, 12, 1, 14, 0]
SPHERE_RADIUS = 0.15
CAM_DISTANCE = 1.0
SPHERE_COLOR = np.array([0.8, 0.35, 0.25])
LIGHT = np.array([0.5, -0.7, 0.5]) / np.linalg.norm([0.5, -0.7, 0.5])
DEPTH_MAX = 2.0  # the 16-bit depth codec's range [0, 2] m, bin 0 = invalid
# the world-axis swap [x, -z, y] of the viewer frame of the training rays
VIEWER_SWAP = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])


def camera_rig(n_cams: int = 16, elevation_deg: float = 22.5) -> Dict[str, np.ndarray]:
    """serial -> OpenCV world_2_cam [4, 4]: alternate lower and upper ring
    (y down), azimuths staggered by half a slot, all looking at the origin."""
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


def intrinsics(original_size: Tuple[int, int]) -> np.ndarray:
    """Full-resolution pinhole matrix of the rig (focal 1.2 x width)."""
    ow, oh = original_size
    return np.array([[ow * 1.2, 0, ow / 2], [0, ow * 1.2, oh / 2], [0, 0, 1.0]])


def shade(origin: np.ndarray, dirs: np.ndarray, time_frac: np.ndarray):
    """Rays (calibration frame, unit ``dirs`` [..., 3], ``time_frac``
    broadcastable to [...]) -> (rgb u8 [..., 3], alpha u8 [...], depth f32
    [...]) of the sphere at its centre for that time."""
    center = np.zeros(np.shape(time_frac) + (3,))
    center[..., 0] = 0.06 * np.asarray(time_frac) - 0.03
    oc = origin - center
    a = (dirs * dirs).sum(-1)
    b = (dirs * oc).sum(-1)
    c = (oc * oc).sum(-1) - SPHERE_RADIUS ** 2
    disc = b * b - a * c
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / np.maximum(a, 1e-12)
    hit = (disc > 0) & (t > 0)
    depth = np.where(hit, t, 0.0).astype(np.float32)
    points = origin + dirs * t[..., None]
    n = (points - center) / SPHERE_RADIUS
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    lit = np.clip((n * LIGHT).sum(-1), 0.0, 1.0) * 0.7 + 0.3
    rgb = np.where(hit[..., None], SPHERE_COLOR * lit[..., None], 0.0)
    rgb_u8 = (np.clip(rgb, 0, 1) * 255).round().astype(np.uint8)
    alpha_u8 = np.where(hit, 255, 0).astype(np.uint8)
    return rgb_u8, alpha_u8, depth


def pixel_rays(w2c: np.ndarray, k: np.ndarray, xs: np.ndarray, ys: np.ndarray):
    """Calibration-frame origin and unit directions of pixels (xs, ys) of
    the camera ``w2c`` with image-scale intrinsics ``k``."""
    c2w = np.linalg.inv(w2c)
    dirs_cam = np.stack([(xs + 0.5 - k[0, 2]) / k[0, 0],
                         (ys + 0.5 - k[1, 2]) / k[1, 1],
                         np.ones_like(xs, float)], axis=-1)
    dirs = dirs_cam @ c2w[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return c2w[:3, 3], dirs


def depth_encode(depth: np.ndarray) -> np.ndarray:
    """Metric depth -> the dataset's 16-bit code (bin 0 invalid)."""
    values = np.array(depth, copy=True)
    values[values > DEPTH_MAX] = 0
    mask = values != 0
    scaled = np.maximum(0, values - 0) * ((2 ** 16 - 2) / DEPTH_MAX) + 1
    scaled = np.asarray(scaled, dtype=np.float64)
    scaled[~mask] = 0
    return scaled.round().astype(np.uint16)


def depth_decode(code: np.ndarray) -> np.ndarray:
    values = (code.astype(np.float32) - 1) / ((2 ** 16 - 2) / DEPTH_MAX)
    values[code == 0] = 0
    return values


def _png(image: np.ndarray) -> bytes:
    """An unfiltered PNG of a uint8/uint16 gray or RGB image."""
    h, w = image.shape[:2]
    channels = 1 if image.ndim == 2 else image.shape[2]
    depth = 16 if image.dtype == np.uint16 else 8
    rows = image.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rows.view(np.uint8).reshape(h, -1)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, {1: 0, 3: 2}[channels], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def write(root: Path, spec: Dict) -> Path:
    """Write the capture ``spec`` (participant, sequence, timesteps, cameras,
    original size) under ``root`` unless a complete copy is there; returns
    the data root. A copy is complete once its ``done`` marker exists; a
    partial one (a run cut while writing) is written again."""
    key = f"p{spec['participant_id']}_{spec['sequence']}_t{spec['n_timesteps']}" \
          f"_c{spec['n_cameras']}_{spec['original_size'][0]}x{spec['original_size'][1]}"
    data_root = Path(root) / key
    if (data_root / "done").exists():
        return data_root
    ow, oh = spec["original_size"]
    w, h = ow // 2, oh // 2
    k_half = intrinsics((ow, oh))
    k_half[:2] /= 2
    poses = camera_rig(spec["n_cameras"])
    participant = data_root / f"{spec['participant_id']:03d}"
    seq = participant / "sequences" / spec["sequence"]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    T = spec["n_timesteps"]
    for t in range(T):
        frame = seq / f"frame_{t:05d}"
        dirs = {"rgb": frame / "images-2x-73fps", "alpha": frame / "alpha_map-73fps",
                "depth": frame / "colmap-73fps" / "depth_maps_compressed"}
        for d in dirs.values():
            d.mkdir(parents=True, exist_ok=True)
        for serial, w2c in poses.items():
            origin, rays = pixel_rays(w2c, k_half, xs, ys)
            rgb, alpha, depth = shade(origin, rays, t / max(T - 1, 1))
            for kind, image in (("rgb", rgb), ("alpha", alpha),
                                ("depth", depth_encode(depth))):
                (dirs[kind] / f"cam_{serial}.png").write_bytes(_png(image))
    cc_dir = participant / "annotations" / spec["sequence"] / "color_correction"
    cc_dir.mkdir(parents=True, exist_ok=True)
    for serial in poses:
        np.save(cc_dir / f"{serial}.npy", np.hstack([np.eye(3), np.zeros((3, 1))]))
    with open(participant / "camera_params.json", "w") as f:
        json.dump({"world_2_cam": {s: m.tolist() for s, m in poses.items()},
                   "intrinsics": intrinsics((ow, oh)).tolist()}, f)
    (data_root / "done").write_text("")
    return data_root


def viewer_poses(spec: Dict, scale: float):
    """Per rig camera (serial order): the viewer-frame centre scaled by
    ``scale`` and the rotation that takes viewer-frame directions to the
    camera's OpenCV frame."""
    centres, to_cam = [], []
    for serial, w2c in camera_rig(spec["n_cameras"]).items():
        c2w = np.linalg.inv(w2c)
        centres.append(VIEWER_SWAP @ c2w[:3, 3] * scale)
        # viewer dir = SWAP R_c2w G d_gl and d_cv = G d_gl, G = diag(1, -1, -1)
        to_cam.append(c2w[:3, :3].T @ VIEWER_SWAP.T)
    return np.stack(centres), np.stack(to_cam)


def expected_pixels(spec: Dict, cam: np.ndarray, t: np.ndarray, xs: np.ndarray,
                    ys: np.ndarray, scale: float) -> Dict[str, np.ndarray]:
    """What the dataset holds at rig camera ``cam`` (serial index), timestep
    ``t``, pixel (xs, ys): rgb composited over white by the alpha map,
    alpha, and depth in viewer units with the dataset's outlier cut."""
    ow, oh = spec["original_size"]
    k_half = intrinsics((ow, oh))
    k_half[:2] /= 2
    poses = list(camera_rig(spec["n_cameras"]).values())
    T = spec["n_timesteps"]
    n = cam.shape[0]
    rgb_u8 = np.zeros((n, 3), np.uint8)
    alpha_u8 = np.zeros(n, np.uint8)
    depth = np.zeros(n, np.float32)
    for c in np.unique(cam):
        sel = cam == c
        origin, dirs = pixel_rays(poses[c], k_half, xs[sel].astype(np.float64),
                                  ys[sel].astype(np.float64))
        rgb_u8[sel], alpha_u8[sel], depth[sel] = shade(
            origin, dirs, t[sel] / max(T - 1, 1))
    rgb = np.clip(rgb_u8.astype(np.float32) / 255.0, 0.0, 1.0)
    rgb = (rgb * 255).round().astype(np.uint8).astype(np.float32) / 255.0
    alpha = alpha_u8.astype(np.float32) / 255.0
    rgb = alpha[:, None] * rgb + (1 - alpha[:, None]) * np.float32(1.0)
    d = depth_decode(depth_encode(depth)).astype(np.float32)
    d[(d < 0.8) | (d > 1.4)] = 0.0
    return {"rgb": rgb.astype(np.float32), "alpha": alpha,
            "depth": (d * scale).astype(np.float32)}


def cache_root() -> Path:
    """The fixed folder of the benchmark's written captures, inside the
    checkout (``benchmark/cache``, kept out of git)."""
    return Path(os.path.dirname(os.path.abspath(__file__))) / "cache" / "captures"
