"""Pose validation CLI of the port: draw the camera rig against the scene box
(nersemble_tpu/scripts/validate_poses.py's arguments and plotted data,
plus ``--device``).

Plots the train cameras' centres (``c2w[:, :3, 3]`` in the viewer frame),
their look directions (``-c2w[:, :3, 2]``: an OpenGL camera looks along
-z) and the 8 corners of the scene box, as three orthographic views (x-y,
x-z, z-y) side by side, with the box's 12 edges. The figure is rasterised
in numpy and written as a PNG through utils/png.py (the GPU machine has no
plotting package and no display): to ``--output``, else
``validate_poses.png`` in the current directory. ``--device`` names the
torch device the port's entry points run on; nothing here computes on it.

Usage:
    python -m nersemble_tpu_torch.scripts.validate_poses 30 SYN-1 [--output poses.png]
"""

import argparse

import numpy as np

from nersemble_tpu_torch.utils import png
from nersemble_tpu_torch.utils.device import resolve_device

PANEL = 320    # pixels per view (square)
MARGIN = 16    # pixels of border inside each view
# (horizontal axis, vertical axis) of each view, as indices into x, y, z
VIEWS = ((0, 1), (0, 2), (2, 1))
BACKGROUND = (255, 255, 255)
CAMERA = (31, 119, 180)       # the JAX figure's "tab:blue"
LOOK = (158, 196, 224)        # the same blue at half opacity on white
BOX = (214, 39, 40)           # "tab:red"
BOX_EDGE = (236, 160, 160)
FRAME = (200, 200, 200)


def pose_geometry(outputs) -> dict:
    """What the figure plots, from the dataparser's train outputs: camera
    centres [N, 3], look directions [N, 3], the arrow length (0.3 of the
    mean centre distance from the origin, the JAX figure's quiver length),
    and the scene box's 8 corners [8, 3] (corner s takes bit d of s to
    choose min or max along axis d)."""
    centers = outputs.c2w[:, :3, 3]
    box = outputs.scene_box
    return {
        "centers": centers,
        "look": -outputs.c2w[:, :3, 2],
        "arrow_length": float(np.linalg.norm(centers, axis=1).mean() * 0.3),
        "corners": np.array([[box[(s >> d) & 1][d] for d in range(3)]
                             for s in range(8)]),
    }


class Figure:
    """Three orthographic views on one canvas, all at one scale that fits
    every plotted point."""

    def __init__(self, geometry: dict):
        ends = geometry["centers"] + geometry["arrow_length"] * geometry["look"]
        points = np.concatenate([geometry["centers"], ends, geometry["corners"]])
        self.lo, hi = points.min(axis=0), points.max(axis=0)
        self.scale = (PANEL - 2 * MARGIN - 1) / max(float((hi - self.lo).max()), 1e-12)
        self.image = np.empty((PANEL, PANEL * len(VIEWS), 3), np.uint8)
        self.image[...] = BACKGROUND

    def pixels(self, points: np.ndarray, view: int) -> np.ndarray:
        """(row, column) of each point [N, 3] on the canvas in ``view``; the
        vertical axis points up."""
        h, v = VIEWS[view]
        col = MARGIN + np.rint((points[:, h] - self.lo[h]) * self.scale)
        row = PANEL - 1 - MARGIN - np.rint((points[:, v] - self.lo[v]) * self.scale)
        return np.stack([row, col + view * PANEL], axis=-1).astype(np.int64)

    def segments(self, start: np.ndarray, end: np.ndarray, colour) -> None:
        for view in range(len(VIEWS)):
            a, b = self.pixels(start, view), self.pixels(end, view)
            n = int(np.abs(b - a).max()) + 1 if len(a) else 1
            t = np.linspace(0.0, 1.0, n)[None, :, None]
            px = np.rint(a[:, None] + t * (b - a)[:, None]).reshape(-1, 2).astype(np.int64)
            self.image[px[:, 0], px[:, 1]] = colour

    def markers(self, points: np.ndarray, colour, radius: int = 2) -> None:
        for view in range(len(VIEWS)):
            for dr in range(-radius, radius + 1):
                for dc in range(-radius, radius + 1):
                    px = self.pixels(points, view) + (dr, dc)
                    self.image[np.clip(px[:, 0], 0, PANEL - 1),
                               np.clip(px[:, 1], 0, self.image.shape[1] - 1)] = colour

    def frames(self) -> None:
        for view in range(1, len(VIEWS)):
            self.image[:, view * PANEL] = FRAME


def draw_poses(geometry: dict) -> np.ndarray:
    """uint8 [PANEL, 3 * PANEL, 3]: box edges, look segments, box corners
    and camera centres, drawn in that order (later ones on top)."""
    fig = Figure(geometry)
    fig.frames()
    corners = geometry["corners"]
    edges = [(a, b) for a in range(8) for b in range(8)
             if a < b and bin(a ^ b).count("1") == 1]
    fig.segments(corners[[a for a, _ in edges]], corners[[b for _, b in edges]], BOX_EDGE)
    centers = geometry["centers"]
    fig.segments(centers, centers + geometry["arrow_length"] * geometry["look"], LOOK)
    fig.markers(corners, BOX)
    fig.markers(centers, CAMERA)
    return fig.image


def main(argv=None, data_location=None, output: str = None) -> dict:
    """Parse ``argv``, draw and write the figure; returns the plotted
    geometry with the PNG's path under ``"output"``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("participant_id", type=int)
    p.add_argument("sequence_name", type=str)
    p.add_argument("--scale-factor", type=float, default=9.0)
    p.add_argument("--output", type=str, default=None,
                   help="PNG to write (default: validate_poses.png here)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the port's entry points (default: the GPU)")
    args = p.parse_args(argv)
    resolve_device(args.device)

    from nersemble_tpu_torch.config import DataConfig
    from nersemble_tpu_torch.data.dataparser import NeRSembleDataParser
    from nersemble_tpu_torch.data.multi_view_data import NeRSembleDataManager

    config = DataConfig(participant_id=args.participant_id,
                        sequence_name=args.sequence_name,
                        n_timesteps=1, scale_factor=args.scale_factor)
    dm = NeRSembleDataManager(args.participant_id, args.sequence_name,
                              location=data_location)
    outputs = NeRSembleDataParser(config, data_manager=dm).generate_outputs("train")
    geometry = pose_geometry(outputs)
    target = args.output or output or "validate_poses.png"
    png.imwrite(target, draw_poses(geometry))
    print(f"[validate-poses] wrote {target}")
    return {**geometry, "output": target}


def entrypoint():
    main()


if __name__ == "__main__":
    entrypoint()
