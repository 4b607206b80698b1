"""Camera pose/intrinsics math and ray generation (host-side numpy; the
port's copy of nersemble_tpu/data/cameras.py).

Absorbs the dreifus Pose/Intrinsics functionality the reference depends on
(reference: nersemble_dataparser.py:187-298, dreifus usage documented in
SURVEY.md section 2b): OpenCV -> OpenGL -> viewer coordinate conversion, world
scaling, intrinsics rescaling, pinhole ray generation in the nerfstudio
convention, circular render trajectories, and view-frustum geometry.

Conventions:
- Calibration world_2_cam poses are OpenCV (x right, y down, z forward).
- Rays/poses used by the model are in the "viewer" frame: OpenGL camera axes
  (x right, y up, z backward) with world axes swapped x, -z, y.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np

# world-axis swap ['x', '-z', 'y'] (reference: nersemble_dataparser.py:210)
_VIEWER_SWAP = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [0.0, 1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])

# negate camera y/z axes: OpenCV <-> OpenGL camera coordinate convention
_CV_TO_GL = np.diag([1.0, -1.0, -1.0, 1.0])


@dataclass
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def from_matrix(m: np.ndarray) -> "CameraIntrinsics":
        m = np.asarray(m)
        return CameraIntrinsics(float(m[0, 0]), float(m[1, 1]),
                                float(m[0, 2]), float(m[1, 2]))

    def to_matrix(self) -> np.ndarray:
        return np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1.0]])

    def rescale(self, factor: float) -> "CameraIntrinsics":
        """Scale to a new output resolution (nerfstudio
        rescale_output_resolution semantics)."""
        return CameraIntrinsics(self.fx * factor, self.fy * factor,
                                self.cx * factor, self.cy * factor)


def world2cam_cv_to_cam2world_viewer(world_2_cam: np.ndarray,
                                     scale_factor: float = 1.0) -> np.ndarray:
    """OpenCV world_2_cam (calibration) -> viewer-frame cam_2_world.

    Matches the reference chain (nersemble_dataparser.py:197-213): invert,
    change camera convention to OpenGL, swap world axes ['x','-z','y'],
    scale the translation.
    """
    c2w = np.linalg.inv(np.asarray(world_2_cam, np.float64))
    c2w = c2w @ _CV_TO_GL  # camera-axis convention: OpenCV -> OpenGL
    c2w = _VIEWER_SWAP @ c2w  # world-axis swap (moves the cameras)
    c2w[:3, 3] *= scale_factor
    return c2w.astype(np.float64)


def cam2world_viewer_to_cv(c2w_viewer: np.ndarray) -> np.ndarray:
    """Viewer-frame OpenGL cam_2_world -> same position with OpenCV camera
    axes (used for frustum construction, reference:
    nersemble_dataparser.py:253)."""
    return np.asarray(c2w_viewer, np.float64) @ _CV_TO_GL


def generate_pixel_rays(c2w: np.ndarray, intrinsics: CameraIntrinsics,
                        pixels_yx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pinhole rays for [N, 2] (row, col) pixel indices.

    nerfstudio convention: pixel centers at +0.5, OpenGL camera axes
    (image y down -> camera y up, looking along -z), directions normalized.
    Returns (origins [N, 3], directions [N, 3]) float32.
    """
    y = pixels_yx[:, 0].astype(np.float64) + 0.5
    x = pixels_yx[:, 1].astype(np.float64) + 0.5
    dirs_cam = np.stack([
        (x - intrinsics.cx) / intrinsics.fx,
        -(y - intrinsics.cy) / intrinsics.fy,
        -np.ones_like(x),
    ], axis=-1)
    rot = c2w[:3, :3]
    dirs = dirs_cam @ rot.T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.broadcast_to(c2w[:3, 3], dirs.shape)
    return origins.astype(np.float32), dirs.astype(np.float32)


def generate_image_rays(c2w: np.ndarray, intrinsics: CameraIntrinsics,
                        height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """All-pixel rays in row-major order: ([H*W, 3], [H*W, 3])."""
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    pixels = np.stack([ys.reshape(-1), xs.reshape(-1)], axis=-1)
    return generate_pixel_rays(c2w, intrinsics, pixels)


def circle_around_axis(n_poses: int, axis: np.ndarray, up: np.ndarray,
                       move: np.ndarray, distance: float) -> np.ndarray:
    """Camera trajectory on a circle, looking at the circle center.

    Absorbed from dreifus ``circle_around_axis`` as used by the render CLI
    (reference: scripts/render/render_nersemble.py:64-72): cameras orbit
    ``move`` at ``distance`` in the plane orthogonal to ``axis``; returns
    [n, 4, 4] OpenCV cam_2_world poses.
    """
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    up = np.asarray(up, np.float64)
    move = np.asarray(move, np.float64)
    # orthonormal basis of the circle plane
    u = np.cross(up, axis)
    if np.linalg.norm(u) < 1e-6:
        u = np.cross(np.array([1.0, 0.0, 0.0]), axis)
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)

    poses = []
    for i in range(n_poses):
        angle = 2 * np.pi * i / n_poses
        position = move + distance * (np.cos(angle) * u + np.sin(angle) * v)
        forward = move - position
        forward /= np.linalg.norm(forward)
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        pose = np.eye(4)
        pose[:3, 0] = right
        pose[:3, 1] = down
        pose[:3, 2] = forward
        pose[:3, 3] = position
        poses.append(pose)
    return np.stack(poses)


class Frustum:
    """Half-space view frustum of a pinhole camera (reference:
    nersemble_volumetric_sampler frustum culling, frustum.py:147-193).

    Built from an OpenCV-convention cam_2_world pose and full-resolution
    intrinsics; four side planes through the camera center with inward
    normals.
    """

    def __init__(self, cam_to_world_cv: np.ndarray, intrinsics: np.ndarray,
                 image_dimensions: Tuple[int, int]):
        img_w, img_h = image_dimensions
        depth = 1.0
        corners_px = np.array([
            [0, 0, depth, 1],
            [img_w * depth, 0, depth, 1],
            [0, img_h * depth, depth, 1],
            [img_w * depth, img_h * depth, depth, 1],
        ], np.float64)
        k_inv = np.eye(4)
        k_inv[:3, :3] = np.linalg.inv(np.asarray(intrinsics, np.float64))
        world = (cam_to_world_cv @ k_inv @ corners_px.T).T[:, :3]
        center = cam_to_world_cv[:3, 3]
        tl, tr, bl, br = world - center
        normals = np.stack([
            np.cross(tl, tr),   # top
            np.cross(tr, br),   # right
            np.cross(br, bl),   # bottom
            np.cross(bl, tl),   # left
        ])
        self.normals = normals / np.linalg.norm(normals, axis=-1, keepdims=True)
        self.center = center

    def contains_points(self, points: np.ndarray) -> np.ndarray:
        """[N, 3] -> [N] bool: inside all four side planes."""
        signed = (points - self.center) @ self.normals.T
        return (signed >= 0).all(axis=-1)
