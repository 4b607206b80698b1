"""Train a textured scene and serve it: the quality benchmark's run, then the
render benchmark and the live viewer on that run.

1. ``scripts/quality_benchmark.py`` trains ``--mode`` for ``--steps`` on a
   fresh textured capture under ``--root`` (eval PSNR/SSIM every
   ``--eval-every`` steps). Printed beside its curve: the PSNR of an image
   that is the background colour everywhere on the same eval views, and the
   median ms/step of the logged intervals (4096 rays over ``rays_per_sec``).
2. ``scripts/bench_render.py`` renders the run along its orbit at 802x550
   (the reference render CLI's 3208x2200 at downscale 4), chunk 16384, with
   the occupancy CC filter (printed beside its JSON: the cells the filter
   kept and its largest thresholded component before the erosion blur),
   then without it, the occupancy binaries the training marched. A grid of
   a few thousand steps has few cells above the filter's threshold, and the
   integer erosion blur erases a component of a few tens of cells, so the
   filtered orbit can be empty where the unfiltered one is not.
3. ``scripts/view_nersemble.py`` serves ``--view-requests`` rgb requests at
   width 256 from a client thread over HTTP on a free local port: ms per
   request, as the browser sees it.

Each part prints its peak device memory and the launches of the port's
kernels (B1-fwd, B2, B3, B4, A3-fwd, A3-bwd), the quality run also the
SHA-256 of its last checkpoint's arrays (two runs that trained bit for bit
print the same); the last line is one JSON object with all of it. Runs on the GPU unless ``--device cpu`` (the CPU path, at tiny sizes,
is a rehearsal: its times are not the card's).

Usage:
    python -m nersemble_tpu_torch.scripts.trained_scene --mode static --steps 3000
    python -m nersemble_tpu_torch.scripts.trained_scene --mode dynamic --steps 6000
"""

import argparse
import contextlib
import hashlib
import json
import socket
import statistics
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

from nersemble_tpu_torch.utils.device import resolve_device

RENDER_ARGS = ["--resolution", "802", "550", "--frames", "8", "--chunk", "16384"]
VIEW_WIDTH = 256


def reset_launches() -> None:
    from nersemble_tpu_torch.ops import launch_counts
    launch_counts.reset()


def launches() -> dict:
    """The port's kernel launches since the last ``reset_launches``."""
    from nersemble_tpu_torch.ops import launch_counts
    return launch_counts.read(launch_counts.KERNELS
                              + ("quad_build narrow", "quad_fold narrow"))


@contextlib.contextmanager
def device_part(device, out: dict):
    """Reset the launch counters and the peak memory; afterwards put the
    part's ``seconds``, ``launches`` and ``peak_gib`` (None off the card)
    into ``out``."""
    import torch
    reset_launches()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    yield out
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - start
    out["launches"] = launches()
    out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                       if device.type == "cuda" else None)


def logged_ms_per_step(run_dir: Path) -> list:
    """ms/step of each logged interval of a run: its rays per step over the
    interval's ``rays_per_sec``, which spans the steps since the previous
    log and any eval or save among them."""
    from nersemble_tpu_torch.config import TrainConfig
    n_rays = TrainConfig.load(run_dir / "config.yml").data.train_num_rays_per_batch
    return [1e3 * n_rays / rec["rays_per_sec"]
            for rec in map(json.loads, (run_dir / "metrics.jsonl").read_text().splitlines())
            if rec.get("rays_per_sec")]


def background_psnr(run_name: str, device) -> float:
    """Mean PSNR over the run's eval views (the eval_all views) of an image
    that is the background colour everywhere: the score of a model that
    renders nothing. Reads the capture at ``env.NERSEMBLE_DATA_PATH``."""
    import torch
    from nersemble_tpu_torch.data.dataparser import NeRSembleDataParser
    from nersemble_tpu_torch.data.dataset import NeRSembleDataset
    from nersemble_tpu_torch.data.ray_batcher import EvalImageLoader
    from nersemble_tpu_torch.model_manager import NeRSembleModelFolder
    from nersemble_tpu_torch.models.nersemble import _BACKGROUNDS
    from nersemble_tpu_torch.utils.metrics import psnr

    config = NeRSembleModelFolder().open_run(run_name).load_config()
    outputs = NeRSembleDataParser(config.data).generate_outputs("val")
    loader = EvalImageLoader(NeRSembleDataset(outputs, config.data))
    background = torch.tensor(_BACKGROUNDS[config.model.background_color],
                              dtype=torch.float32, device=device)
    scores = []
    for i in range(len(loader)):
        gt = torch.from_numpy(loader.image_rays(i)["gt_rgb"]).to(device)
        scores.append(float(psnr(background.expand_as(gt), gt)))
    return float(np.mean(scores))


@contextlib.contextmanager
def roots(root: Path):
    """Point the port's data and models roots at ``root``/data and
    ``root``/models inside the block."""
    from nersemble_tpu_torch import env
    saved = (env.NERSEMBLE_DATA_PATH, env.NERSEMBLE_MODELS_PATH)
    env.NERSEMBLE_DATA_PATH = str(root / "data")
    env.NERSEMBLE_MODELS_PATH = str(root / "models")
    try:
        yield
    finally:
        env.NERSEMBLE_DATA_PATH, env.NERSEMBLE_MODELS_PATH = saved


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def time_viewer(run_name: str, n_requests: int, device, width: int = VIEW_WIDTH) -> list:
    """The view CLI on ``run_name`` serving ``n_requests`` rgb requests at
    ``width`` from a client thread (orbit az 0.6, el 0.2, t 0.5); returns
    each request's ms and PNG size as the client saw them."""
    from nersemble_tpu_torch.scripts import view_nersemble

    port = free_port()
    replies, errors = [], []
    url = (f"http://127.0.0.1:{port}/render?channel=rgb&width={width}"
           f"&az=0.6&el=0.2&t=0.5")

    def client():
        try:
            for _ in range(n_requests):
                deadline = time.time() + 300
                while True:
                    start = time.perf_counter()
                    try:
                        with urllib.request.urlopen(url, timeout=300) as reply:
                            body = reply.read()
                        replies.append((1e3 * (time.perf_counter() - start), len(body)))
                        break
                    except urllib.error.URLError:
                        if time.time() > deadline:
                            raise
                        time.sleep(0.2)
        except Exception as e:  # handed to the caller below
            errors.append(e)

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    served = view_nersemble.main([run_name, "--port", str(port), "--device", str(device)],
                                 max_requests=n_requests)
    thread.join(timeout=60)
    if errors:
        raise errors[0]
    if served != n_requests or len(replies) != n_requests:
        raise RuntimeError(f"the viewer served {served} requests, the client "
                           f"got {len(replies)} replies, of {n_requests}")
    return replies


def checkpoint_digest(run_dir: Path) -> str:
    """SHA-256 over the parameters, optimizer state and grid of the run's
    last checkpoint, key by key in sorted order: two runs that trained bit
    for bit give the same digest."""
    ckpt = sorted((run_dir / "checkpoints").glob("step-*.ckpt"))[-1]
    digest = hashlib.sha256()
    with np.load(ckpt) as data:
        for key in sorted(k for k in data.files
                          if k.startswith(("params/", "opt_state/", "grid_occs"))):
            digest.update(key.encode())
            digest.update(np.ascontiguousarray(data[key]).tobytes())
    return digest.hexdigest()


def train_scene(args, device) -> dict:
    """Part 1: the quality run, its background PSNR, its ms/step and the
    digest of its last checkpoint."""
    from nersemble_tpu_torch.scripts import quality_benchmark

    part = {}
    with device_part(device, part):
        quality = quality_benchmark.run(
            args.mode, args.steps, str(args.root / "data"), str(args.root / "models"),
            args.eval_every, texture_style=args.texture_style, device=device)
    run_dir = Path(quality["run_dir"])
    with roots(args.root):
        bg = background_psnr(run_dir.name, device)
    ms = logged_ms_per_step(run_dir)
    part.update(quality=quality, run=run_dir.name, background_psnr=bg,
                ms_per_step_median=statistics.median(ms) if ms else None,
                checkpoint_digest=checkpoint_digest(run_dir))
    print(f"[trained-scene] {args.mode}: {args.steps} steps in "
          f"{quality['wall_clock_s']} s, median {part['ms_per_step_median']} ms/step "
          f"over the logged intervals; eval PSNR by step "
          f"{[(p['step'], p['eval_psnr']) for p in quality['eval_curve']]}, an all-"
          f"background image {bg:.3f} dB; peak memory {part['peak_gib']} GiB; "
          f"launches {part['launches']}; last checkpoint's SHA-256 "
          f"{part['checkpoint_digest']}", flush=True)
    return part


def render_scene(args, run_name: str, device) -> dict:
    """Part 2: bench_render on the run with the CC filter (the render and
    eval protocol; its cells), then without it (the grid the run trained and
    marched)."""
    from nersemble_tpu_torch.scripts import bench_render

    base = ["--models-root", str(args.root / "models"), "--data-root",
            str(args.root / "data"), "--run", run_name, "--device", str(device)]
    part = {}
    for key, flags in (("filtered", []), ("unfiltered", ["--no-cc-filter"])):
        out = {}
        with roots(args.root), device_part(device, out):
            out["bench"] = bench_render.main(base + RENDER_ARGS + flags)
        part[key] = out
        extra, cells = out["bench"]["extra"], out["bench"]["cc_cells"]
        print(f"[trained-scene] render {extra['resolution']} {key}: "
              f"{extra['ms_per_frame']} ms/frame, auto budget {extra['auto_budget']}, "
              f"hit fraction {extra['hit_ray_fraction']}, mean accumulation "
              f"{extra['mean_accumulation']}"
              + (f", CC filter kept {cells['kept']} cells (largest thresholded "
                 f"component {cells['component']})" if cells else "")
              + f"; peak memory {out['peak_gib']} GiB; launches {out['launches']}",
              flush=True)
    return part


def view_scene(args, run_name: str, device) -> dict:
    """Part 3: the viewer's ms per request at width 256."""
    part = {}
    with roots(args.root), device_part(device, part):
        part["requests"] = time_viewer(run_name, args.view_requests, device)
    print(f"[trained-scene] viewer at width {VIEW_WIDTH}: ms per request "
          f"{[round(ms, 1) for ms, _ in part['requests']]}; peak memory "
          f"{part['peak_gib']} GiB; launches {part['launches']}", flush=True)
    return part


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["static", "dynamic"], default="static")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--texture-style", choices=["default", "sharp"], default="default",
                    help="the capture's texture (quality_benchmark.py's flag)")
    ap.add_argument("--view-requests", type=int, default=5)
    ap.add_argument("--root", type=Path, default=None,
                    help="capture and runs go here, and stay (default: a new "
                         "temporary directory)")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the summary JSON here")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the runs (default: the GPU)")
    return ap


def main(argv=None) -> dict:
    import tempfile

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    args.root = args.root or Path(tempfile.mkdtemp(prefix="nersemble_trained_scene_"))
    summary = {"mode": args.mode, "steps": args.steps,
               "texture_style": args.texture_style, "root": str(args.root)}
    summary["train"] = train_scene(args, device)
    run_name = summary["train"]["run"]
    summary["render"] = render_scene(args, run_name, device)
    summary["view"] = view_scene(args, run_name, device)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
