"""Render benchmark of the port: novel-view frames/s on a trained run
(scripts/bench_render.py's flags and JSON line, plus ``--device``).

Loads a trained run (default: the newest quality-static run of
scripts/quality_benchmark.py under ``--models-root``) as an eval-only
trainer, carves its occupancy grid to the largest connected component
(unless ``--no-cc-filter``), and renders full frames along a circle around
the synthetic object through ``NeRSembleTrainer.render_image(...,
budget="auto")``: one warm-up frame, then ``--frames`` timed ones. Prints
one JSON line with frames/s, ms/frame, the probed auto budget, the mean
accumulation, the share of rays that can hit an occupied cell, the card's
name and power limit, and the launches of the fused MLP forward (B1-fwd)
and the quad build (B3) per rendered frame (warm-up and traced frames
included: the quad table is built once per grid state). ``main`` returns
that line plus ``cc_cells``: the cells the CC filter kept and its largest
thresholded component before the erosion blur. Runs on the GPU unless
``--device cpu``.

Usage:
    python -m nersemble_tpu_torch.scripts.bench_render [--run NERS-001-quality-static]
        [--frames 8] [--resolution 802 550] [--chunk 16384] [--trace DIR]
"""

import argparse
import glob
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from nersemble_tpu_torch.scripts.quality_benchmark import (
    DEFAULT_DATA_ROOT,
    DEFAULT_MODELS_ROOT,
    card_identity,
)
from nersemble_tpu_torch.utils.device import resolve_device

_CV_TO_GL = np.diag([1.0, -1.0, -1.0, 1.0])


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--models-root", default=DEFAULT_MODELS_ROOT)
    ap.add_argument("--data-root", default=DEFAULT_DATA_ROOT)
    ap.add_argument("--run", default=None,
                    help="run name; default = latest quality-static run")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--downscale", type=int, default=1,
                    help="extra downscale on top of the dataset's")
    ap.add_argument("--resolution", type=int, nargs=2, default=None,
                    metavar=("H", "W"),
                    help="render at an explicit resolution instead of the "
                         "dataset's (e.g. 802 550 = the reference render "
                         "CLI's 3208x2200 at downscale 4, ~441k rays/frame); "
                         "intrinsics are rescaled from the original image size")
    ap.add_argument("--chunk", type=int, default=2 ** 14)
    ap.add_argument("--trace", type=str, default=None,
                    help="write a torch.profiler trace of 2 frames to this dir")
    ap.add_argument("--orbit-distance", type=float, default=1.0,
                    help="orbit radius in calibration units (synthetic rig "
                         "cameras sit at 1.0)")
    ap.add_argument("--orbit-center", type=float, nargs=3, default=(0, 0, 0),
                    help="orbit/look-at center in calibration units (the "
                         "synthetic object is at the origin)")
    ap.add_argument("--no-cc-filter", action="store_true",
                    help="skip the occupancy CC postfilter (the render/eval "
                         "CLIs apply it by default)")
    ap.add_argument("--cc-threshold", type=float, default=0.05)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the run (default: the GPU)")
    return ap


def frame_intrinsics(trainer, config, resolution, downscale):
    """(intrinsics, height, width) of the benchmark's frames. An explicit
    ``resolution`` scales the capture's intrinsics by the height ratio and
    recentres the principal point, so the object fills the frame as it
    fills the capture's (scaling by the width ratio would widen the view and
    pad the frame with cheap background rays)."""
    from nersemble_tpu_torch.data.cameras import CameraIntrinsics

    out = trainer.train_outputs
    intr = trainer.dataparser.data_manager.load_camera_params().intrinsics
    if resolution is not None:
        height, width = resolution
        original_w = out.image_width * config.data.downscale_factor
        original_h = out.image_height * config.data.downscale_factor
        s = height / original_h
        r = intr.rescale(s)
        return CameraIntrinsics(r.fx, r.fy, r.cx + (width - original_w * s) / 2.0,
                                r.cy + (height - original_h * s) / 2.0), height, width
    intr = intr.rescale(1.0 / (config.data.downscale_factor * downscale))
    return intr, out.image_height // downscale, out.image_width // downscale


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    import torch
    from nersemble_tpu_torch import env
    from nersemble_tpu_torch.data.cameras import circle_around_axis, generate_image_rays
    from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
    from nersemble_tpu_torch.model_manager import NeRSembleModelFolder
    from nersemble_tpu_torch.ops import launch_counts

    env.NERSEMBLE_DATA_PATH = args.data_root
    env.NERSEMBLE_MODELS_PATH = args.models_root

    run = args.run
    if run is None:
        runs = sorted(glob.glob(os.path.join(args.models_root, "nersemble",
                                             "*quality-static*")))
        if not runs:
            raise SystemExit("no quality-static run found; run "
                             "nersemble_tpu_torch.scripts.quality_benchmark first")
        run = os.path.basename(runs[-1])

    manager = NeRSembleModelFolder().open_run(run)
    config = manager.load_config()
    config.load_dir = manager.get_checkpoint_folder()
    config.vis = "none"
    trainer = NeRSembleTrainer.from_train_config(config, model_manager=manager,
                                                 eval_only=True, device=device)
    checkpoint = trainer.start_step - 1

    cc_cells = None
    if not args.no_cc_filter and not config.model.disable_occupancy_grid:
        # the render/eval protocol carves the grid to its largest connected
        # component before rendering; benching without it overstates the
        # marched samples
        from nersemble_tpu_torch.utils.connected_components import (
            filter_occupancy_grid_mask,
            largest_component_cells,
        )
        occs = trainer.grid_occs.cpu().numpy()
        resolution = config.model.grid_resolution
        mask = filter_occupancy_grid_mask(occs, resolution, threshold=args.cc_threshold)
        trainer.apply_grid_mask(mask)
        cc_cells = {"kept": int(mask.sum()), "component": largest_component_cells(
            occs, resolution, threshold=args.cc_threshold)}

    # orbit the synthetic object at the calibration-space origin (rig
    # cameras at distance 1.0, y down)
    poses_cv = circle_around_axis(args.frames, axis=(0, 1, 0), up=(0, -1, 0),
                                  move=tuple(args.orbit_center),
                                  distance=args.orbit_distance)
    scale = config.data.scale_factor
    intr, height, width = frame_intrinsics(trainer, config, args.resolution,
                                           args.downscale)

    def pose(i):
        p = poses_cv[i % args.frames].copy() @ _CV_TO_GL
        p[:3, 3] *= scale
        return p

    n_rendered = [0]

    def render(i):
        origins, dirs = generate_image_rays(pose(i), intr, height, width)
        image_rays = {
            "origins": origins, "directions": dirs,
            "timesteps": np.zeros(origins.shape[0], np.int32),
            "camera_indices": np.zeros(origins.shape[0], np.int32),
            "height": height, "width": width,
        }
        n_rendered[0] += 1
        return trainer.render_image(image_rays, step=checkpoint,
                                    chunk=args.chunk, budget="auto")

    # the share of frame 0's rays that can hit an occupied cell (the rest
    # are skipped by the eval ray packing)
    if config.model.disable_occupancy_grid:
        hit_fraction = 1.0
    else:
        o0, d0 = generate_image_rays(pose(0), intr, height, width)
        hit_fraction = float(trainer.renderer().render_hit_mask(
            torch.from_numpy(o0).to(device), torch.from_numpy(d0).to(device))
            .float().mean())

    launches0 = launch_counts.read(launch_counts.FORWARD)
    render(0)  # warm-up: the quad table and the auto budget's probe
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=activities) as prof:
            render(1)
            render(2)
        Path(args.trace).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.trace) / "trace.json"))
    t0 = time.perf_counter()
    acc_mean = 0.0
    for i in range(args.frames):
        frame = render(i)
        acc_mean += float(frame["accumulation"].mean()) / args.frames
    dt = time.perf_counter() - t0
    fps = args.frames / dt
    if acc_mean < 0.01:
        print("WARNING: trajectory renders (almost) nothing — acc_mean "
              f"{acc_mean:.4f}; fps below measures the empty-frame case",
              file=sys.stderr)
    name, power_limit = card_identity(device)
    result = {
        "metric": "render_fps",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / 5.0, 3),  # the > 5 fps target
        "extra": {
            "resolution": [height, width],
            "rays_per_frame": height * width,
            "ms_per_frame": round(dt / args.frames * 1000, 1),
            "chunk": args.chunk,
            "auto_budget": trainer.renderer().auto_budget,
            "mean_accumulation": round(acc_mean, 4),
            "hit_ray_fraction": round(hit_fraction, 4),
            "cc_filter": not args.no_cc_filter,
            "run": run,
            "device": name,
            "power_limit": power_limit,
            "launches_per_frame": {
                name: (count - launches0[name]) / n_rendered[0]
                for name, count in launch_counts.read(launch_counts.FORWARD).items()},
        },
    }
    print(json.dumps(result))
    # returned beside the JAX line: the cells the CC filter kept, and its
    # largest thresholded component before the erosion blur (None unfiltered)
    return {**result, "cc_cells": cc_cells}


if __name__ == "__main__":
    main()
