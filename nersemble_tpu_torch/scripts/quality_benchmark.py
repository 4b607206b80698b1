"""Quality benchmark of the port: convergence of the benched configuration
on a textured synthetic capture (scripts/quality_benchmark.py's flags,
arguments and result, plus ``--device``).

Writes a textured, non-rigidly deforming synthetic sequence in the
published on-disk layout (utils/synthetic_capture.py), trains the
configuration bench.py measures (S=256 slots, global budget fraction 0.125,
auto-sized candidates; static: the single grid without deformation on one
timestep, dynamic: the hash ensemble with the SE(3) field) through the
port's train CLI, and reads hold-out PSNR/SSIM curves and the sample-drop
diagnostics back from the run's ``metrics.jsonl``. The result goes to
``--out``, by default ``quality.json`` under ``--models-root`` (never into
the repository), keyed by mode, and a summary is printed. A run whose
logged loss or eval score turns non-finite raises instead (the JAX script
records its background-only curve). Runs on the GPU unless ``--device cpu``.

Usage:
    python -m nersemble_tpu_torch.scripts.quality_benchmark --mode static --steps 3000
    python -m nersemble_tpu_torch.scripts.quality_benchmark --mode dynamic --steps 6000
"""

import argparse
import glob
import json
import math
import os
import tempfile
import time
from pathlib import Path
from typing import Sequence

from nersemble_tpu_torch.utils.device import resolve_device

DEFAULT_DATA_ROOT = os.path.join(tempfile.gettempdir(), "ns_quality_data")
DEFAULT_MODELS_ROOT = os.path.join(tempfile.gettempdir(), "ns_quality_models")
CAPTURE_SIZE = (256, 352)  # original (width, height); stored at 128x176


def build_train_args(mode: str, steps: int, seq: str, eval_every: int,
                     n_tables: int = 16, steps_per_save: int = 2000,
                     run_suffix: str = "") -> list:
    """Train-CLI arg list for a quality run: the benched configuration with
    its schedules compressed to the run length (the JAX script's list, item
    for item)."""
    args = [
        "30", seq,
        "--name", f"quality-{mode}{run_suffix}",
        "--max-num-iterations", str(steps + 1),
        "--steps-per-save", str(min(steps_per_save, steps)),
        "--steps-per-eval-image", "0",
        "--steps-per-eval-batch", "0",
        "--steps-per-eval-all-images", str(eval_every),
        "--n-train-rays", "4096",
        "--max-samples-per-ray", "256",
        "--max-candidates-per-ray", "-1",  # auto-span
        "--global-budget-fraction", "0.125",
    ]
    # the depth-band anneal compressed to the run length
    args += ["--eps-depth-end-step", str(max(steps // 3, 1))]
    if mode == "static":
        args += ["--n-timesteps", "1",
                 "--window-deform-end", "0",
                 "--window-hash-encodings-begin", "0",
                 "--window-hash-encodings-end", "0",
                 "--no-use-deformation-field",
                 "--no-use-hash-ensemble"]
    else:
        # every table's fade-in gets >= 500 steps and ends well before the
        # run does; the per-timestep blend code matches the table count; the
        # adaptive budget may grow to cover the uncarved fade-in's samples
        args += ["--n-hash-encodings", str(n_tables),
                 "--latent-dim-time", str(n_tables),
                 "--adaptive-budget-max-chunks", "3"]
        begin = max(steps // 10, 1)
        end = begin + 500 * n_tables
        if end > int(steps * 0.85):
            end = int(steps * 0.85)
            print(f"[quality] WARNING: {steps} steps give only "
                  f"{(end - begin) / n_tables:.0f} steps/table of hash "
                  f"fade-in (want >= 500; use --steps >= "
                  f"{int((begin + 500 * n_tables) / 0.85)})")
        args += ["--window-deform-end", str(begin),
                 "--window-hash-encodings-begin", str(begin),
                 "--window-hash-encodings-end", str(end)]
    return args


def card_identity(device):
    """(device name, power limit) of the run: nvidia-smi's name and limit on
    a GPU, ("cpu", None) on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    from nersemble_tpu_torch.utils.timing import nvidia_smi
    name, limit = (s.strip() for s in nvidia_smi("name,power.limit").split(",", 1))
    return name, limit


def read_quality_metrics(metrics_path: Path) -> dict:
    """The eval curve, drop curve and last per-camera / per-timestep eval
    breakdown of a run's metrics.jsonl. The file appends across resumes, so
    steps can go back at a resume: every point carries the index of its
    branch (0 for the first run, +1 per resume)."""
    curve, drops = [], []
    breakdown = {}
    branch, last_step = 0, -1
    for line in metrics_path.read_text().splitlines():
        rec = json.loads(line)
        step = rec.get("step", -1)
        if step < last_step:
            branch += 1
        last_step = step
        if "eval_all_psnr" in rec:
            point = {"step": step, "branch": branch,
                     "eval_psnr": round(rec["eval_all_psnr"], 3),
                     "eval_ssim": round(rec.get("eval_all_ssim", 0), 4)}
            if "eval_all_psnr_masked" in rec:
                point["eval_psnr_masked"] = round(rec["eval_all_psnr_masked"], 3)
            curve.append(point)
            breakdown = {k: round(v, 3) for k, v in rec.items()
                         if k.startswith("eval_cam") or k.startswith("eval_t")}
        if "budget_dropped_per_batch" in rec:
            drops.append({"step": step, "branch": branch,
                          "samples": rec.get("samples_per_batch"),
                          "slot_dropped": rec.get("dropped_samples_per_batch"),
                          "budget_dropped": rec["budget_dropped_per_batch"]})
    # the whole drop curve, every (n // 80)-th point and the last (the JAX
    # script's rule: 80 to 160 points of a long run)
    stride = max(len(drops) // 80, 1)
    drop_curve = drops[::stride]
    if drops and drop_curve[-1] is not drops[-1]:
        drop_curve.append(drops[-1])
    return {"n_resumes": branch, "eval_curve": curve,
            "final_eval_breakdown": breakdown, "drop_curve": drop_curve,
            "drop_diagnostics_tail": drops[-5:]}


def first_non_finite(metrics_path: Path):
    """(step, key) of the first logged train loss or eval score of a run
    that is not finite, else None."""
    for line in metrics_path.read_text().splitlines():
        rec = json.loads(line)
        for key in ("train_loss", "eval_all_psnr", "eval_all_ssim"):
            if key in rec and not math.isfinite(rec[key]):
                return rec.get("step"), key
    return None


def run(mode: str, steps: int, data_root: str, models_root: str,
        eval_every: int, n_timesteps_dyn: int = 16,
        n_tables: int = 16, resume_run: str = None,
        steps_per_save: int = 2000, texture_style: str = "default",
        device="cuda", extra_args: Sequence[str] = ()) -> dict:
    """Write the capture, train (or resume ``resume_run``) through the
    train CLI on ``device``, and read the run's curves back.
    ``extra_args``: train-CLI flags after the configuration's (the last
    value of a flag wins). Raises if a logged loss or eval score is not
    finite: such a run renders background from then on, and its curve
    would read as a result."""
    from nersemble_tpu_torch import env
    from nersemble_tpu_torch.scripts import train_nersemble
    from nersemble_tpu_torch.utils.synthetic_capture import make_synthetic_dataset

    device = resolve_device(device)
    n_timesteps = 1 if mode == "static" else n_timesteps_dyn
    squash = 0.0 if mode == "static" else 0.15
    seq = f"SYN-Q-{mode.upper()}"
    if texture_style != "default":
        seq += f"-{texture_style.upper()}"
    make_synthetic_dataset(data_root, sequence_name=seq, n_timesteps=n_timesteps,
                           original_size=CAPTURE_SIZE, texture=True, squash=squash,
                           texture_style=texture_style)

    suffix = "" if texture_style == "default" else f"-{texture_style}"
    if resume_run:
        # the config (schedules included) reloads from the run folder and
        # metrics.jsonl appends, so the curve stays complete
        args = ["30", seq, "--resume-run", resume_run,
                "--max-num-iterations", str(steps + 1)]
    else:
        args = build_train_args(mode, steps, seq, eval_every, n_tables=n_tables,
                                steps_per_save=steps_per_save, run_suffix=suffix)
    args += [*extra_args, "--device", str(device)]

    saved = (env.NERSEMBLE_DATA_PATH, env.NERSEMBLE_MODELS_PATH)
    env.NERSEMBLE_DATA_PATH, env.NERSEMBLE_MODELS_PATH = data_root, models_root
    try:
        t0 = time.time()
        result = train_nersemble.main(args)
        wall = time.time() - t0
    finally:
        env.NERSEMBLE_DATA_PATH, env.NERSEMBLE_MODELS_PATH = saved

    run_dirs = sorted(glob.glob(os.path.join(
        models_root, "nersemble", resume_run or f"*quality-{mode}{suffix}")))
    metrics_path = Path(run_dirs[-1]) / "metrics.jsonl"
    bad = first_non_finite(metrics_path)
    if bad is not None:
        raise RuntimeError(f"{run_dirs[-1]}: {bad[1]} is not finite at step {bad[0]}; "
                           f"the run diverged, refusing its curve")
    name, power_limit = card_identity(device)
    return {
        "mode": mode,
        "steps": steps,
        "wall_clock_s": round(wall, 1),
        "final_train_psnr": round(result.get("train_psnr", float("nan")), 3),
        **read_quality_metrics(metrics_path),
        "run_dir": run_dirs[-1],
        "n_timesteps": n_timesteps,
        "device": name,
        "power_limit": power_limit,
    }


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["static", "dynamic", "both"], default="both")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--steps-per-save", type=int, default=2000)
    ap.add_argument("--texture-style", choices=["default", "sharp"], default="default",
                    help="'sharp' adds strong very-high-frequency surface "
                         "texture: the carving pressure smooth textures lack")
    ap.add_argument("--n-timesteps", type=int, default=16,
                    help="dynamic-mode sequence length")
    ap.add_argument("--n-tables", type=int, default=16,
                    help="dynamic-mode hash-ensemble size")
    ap.add_argument("--data-root", default=DEFAULT_DATA_ROOT)
    ap.add_argument("--models-root", default=DEFAULT_MODELS_ROOT)
    ap.add_argument("--out", default=None,
                    help="result JSON (default: quality.json under --models-root)")
    ap.add_argument("--resume-run", default=None,
                    help="resume a killed single-mode run (e.g. NERS-004-"
                         "quality-static) from its latest periodic "
                         "checkpoint; requires --mode static|dynamic")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the runs (default: the GPU)")
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.resume_run and args.mode not in ("static", "dynamic"):
        ap.error("--resume-run needs an explicit --mode")
    resolve_device(args.device)
    out = Path(args.out or os.path.join(args.models_root, "quality.json"))

    modes = ["static", "dynamic"] if args.mode == "both" else [args.mode]
    results = json.loads(out.read_text()) if out.exists() else {}
    for mode in modes:
        steps = args.steps or (3000 if mode == "static" else 12000)
        key = mode if args.texture_style == "default" else f"{mode}_{args.texture_style}"
        results[key] = run(mode, steps, args.data_root, args.models_root,
                           args.eval_every, n_timesteps_dyn=args.n_timesteps,
                           n_tables=args.n_tables, resume_run=args.resume_run,
                           steps_per_save=args.steps_per_save,
                           texture_style=args.texture_style, device=args.device)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=2))
        print(f"\n=== {key}: final train PSNR {results[key]['final_train_psnr']} ===")
        for point in results[key]["eval_curve"]:
            print(f"  step {point['step']:6d}: eval PSNR {point['eval_psnr']}"
                  f"  SSIM {point['eval_ssim']}")
    print(f"\nwrote {out}")
    return results


if __name__ == "__main__":
    main()
