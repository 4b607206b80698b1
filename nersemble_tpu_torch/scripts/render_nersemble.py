"""Render CLI of the port: circular novel-view trajectory over the full
sequence (nersemble_tpu/scripts/render_nersemble.py's flags, defaults and
outputs, plus ``--device``).

Reference: scripts/render/render_nersemble.py:20-99 + util/render.py:13-73.
Orbits the head (circle around axis (0,1,0), offset (0,-1,0), radius 0.3,
scaled by the world scale factor), sweeps time 0 -> 1 over seconds*fps frames,
renders rgb / depth / deformation channels at 1/downscale resolution, and
writes each channel as a directory of PNG frames under
NERSEMBLE_RENDERS_PATH named ``{run}_{channel}{label}`` (utils/videoio.py:
the JAX package's layout when it has no video encoder). Runs on the GPU
unless ``--device cpu``; reads run folders written by either package. It
runs on the ranks of the run's ``config.parallel.data_axis_size`` as the
evaluate CLI does: every rank renders its share of each frame's chunks, and
rank 0 alone colours the channels, prints and writes.

Usage:
    python -m nersemble_tpu_torch.scripts.render_nersemble NERS-XXX [flags]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from nersemble_tpu_torch import env
from nersemble_tpu_torch.data.cameras import circle_around_axis, generate_image_rays
from nersemble_tpu_torch.parallel import launch
from nersemble_tpu_torch.scripts.evaluate_nersemble import eval_trainer, open_run
from nersemble_tpu_torch.utils.colormaps import (
    apply_depth_colormap,
    apply_scene_flow_colormap,
)
from nersemble_tpu_torch.utils.videoio import write_video


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_name", type=str)
    p.add_argument("--seconds", type=int, default=4)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--n-rays", type=int, default=2 ** 13)
    p.add_argument("--downscale-factor", type=int, default=4)
    p.add_argument("--render-depth", action="store_true")
    p.add_argument("--render-deformations", action="store_true")
    p.add_argument("--use-occupancy-grid-filtering", action="store_true")
    p.add_argument("--occupancy-grid-filtering-threshold", type=float, default=0.05)
    p.add_argument("--occupancy-grid-filtering-sigma-erosion", type=float, default=7)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default: the GPU)")
    return p


def main(argv=None, renders_path=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    _, config = open_run(args)
    renders_path = str(renders_path or env.NERSEMBLE_RENDERS_PATH)
    outputs = launch.run_cli("nersemble_tpu_torch.scripts.render_nersemble", argv,
                             args.device, config.parallel.data_axis_size, renders_path)
    return outputs


def run(argv, mesh=None, renders_path=None):
    """The render of ``argv`` on this rank (``mesh`` None: one process):
    rank 0's written paths by channel, None on the other ranks."""
    args = build_parser().parse_args(argv)
    manager, config = open_run(args)
    trainer = eval_trainer(config, manager, args, mesh)
    checkpoint = trainer.start_step - 1
    chief = trainer.is_chief

    # trajectory (reference: render_nersemble.py:63-77): OpenCV-convention
    # circle poses -> OpenGL/viewer-style pose with scaled translation
    n_frames = args.seconds * args.fps
    poses_cv = circle_around_axis(n_frames, axis=(0, 1, 0), up=(0, 0, 1),
                                  move=(0, -1, 0), distance=0.3)
    scale = config.data.scale_factor
    c2w = []
    for pose in poses_cv:
        p = pose.copy() @ np.diag([1.0, -1.0, -1.0, 1.0])  # OpenCV -> OpenGL axes
        p[:3, 3] *= scale
        c2w.append(p)

    out = trainer.train_outputs
    intr_full = trainer.dataparser.data_manager.load_camera_params().intrinsics
    ds = args.downscale_factor
    intr = intr_full.rescale(1.0 / ds)
    width = out.image_width * config.data.downscale_factor // ds
    height = out.image_height * config.data.downscale_factor // ds

    n_timesteps = config.data.n_timesteps
    times = np.linspace(0.0, 1.0, n_frames)
    timesteps = np.round(times * (n_timesteps - 1)).astype(np.int32)

    frames = {"rgb": []}
    if args.render_depth:
        frames["depth"] = []
    if args.render_deformations and config.model.use_deformation_field:
        frames["deformation"] = []

    start = time.perf_counter()
    for i in range(n_frames):
        origins, dirs = generate_image_rays(c2w[i], intr, height, width)
        image_rays = {
            "origins": origins, "directions": dirs,
            "timesteps": np.full(origins.shape[0], timesteps[i], np.int32),
            "height": height, "width": width,
        }
        rendered = trainer.render_image(image_rays, step=checkpoint,
                                        chunk=args.n_rays)
        if not chief:  # every rank renders its share; rank 0 writes
            continue
        frames["rgb"].append(rendered["rgb"])
        if "depth" in frames:
            # near/far like the reference video renderer (util/render.py:44-50)
            frames["depth"].append(apply_depth_colormap(
                rendered["depth"], rendered["accumulation"],
                near=0.8 * scale, far=1.2 * scale))
        if "deformation" in frames and "deformation" in rendered:
            frames["deformation"].append(apply_scene_flow_colormap(
                rendered["deformation"]))
        if i % 8 == 0:
            print(f"[render] frame {i + 1}/{n_frames}")
    render_s = time.perf_counter() - start
    if not chief:
        return None
    print(f"[render] {n_frames} frames {width}x{height} in {render_s:.2f} s "
          f"({1e3 * render_s / max(n_frames, 1):.1f} ms/frame with the colormaps)")

    label = "_occ_grid_filtering" if args.use_occupancy_grid_filtering else ""
    label += f"_checkpoint-{checkpoint}"
    outputs = {}
    for channel, imgs in frames.items():
        path = Path(renders_path) / f"{manager.get_run_name()}_{channel}{label}.mp4"
        outputs[channel] = write_video(path, imgs)
        print(f"[render] wrote {outputs[channel]}")
    return outputs


def entrypoint():
    main()


if __name__ == "__main__":
    entrypoint()
