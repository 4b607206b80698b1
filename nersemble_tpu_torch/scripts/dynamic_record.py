"""The port's run of the JAX package's recorded dynamic quality run.

``QUALITY_r5.json`` ("dynamic", ``dynamic_schedule_trim_note``) records a
run of ``scripts/quality_benchmark.py --mode dynamic --n-tables 32`` on the
textured capture (16 timesteps): the schedule that ``--steps 22000`` gives
(hash fade-in 2200 -> 18200, eps-depth anneal end 7333), evaluated every
750 steps; at step 3000 the schedule was compressed in the run's
``config.yml`` (fade-in end 5200, eps-depth end 2500) and the run resumed
to step 7500. This script runs the same two legs through the port's
``quality_benchmark.run``:

1. a new run with the 22,000-step schedule that ends after step 3000 (its
   checkpoint);
2. the run's ``config.yml`` compressed as the record's was, then
   ``--resume-run`` to step 7500.

Both legs run in one process, since the checkpoint that carries the run
over (about 5 GB at 32 tables) stays on this machine's disk. Printed: the
port's eval curve beside the record's points, the PSNR of an all-background
image on the same views, and the forensics of the last checkpoint
(``dynamic_forensics.py``); the last line is one JSON object. Runs on the
GPU unless ``--device cpu``.

Usage:
    python -m nersemble_tpu_torch.scripts.dynamic_record --out record.json
"""

import argparse
import json
import tempfile
import time
from pathlib import Path

from nersemble_tpu_torch.utils.device import resolve_device

# QUALITY_r5.json "dynamic" eval_curve: step -> eval PSNR (dB) of the
# branch that supersedes (branch 0 to step 3000, branch 1 after it)
RECORD_PSNR = {750: 14.099, 1500: 14.671, 2250: 15.171, 3000: 15.493,
               3750: 16.71, 4500: 17.896, 5250: 19.643, 6000: 20.542,
               6750: 20.934, 7500: 21.371}
SCHEDULE_STEPS, RESUME_AT, END, EVAL_EVERY, N_TABLES = 22000, 3000, 7500, 750, 32
FADE_END, EPS_DEPTH_END = 5200, 2500


def compress_schedule(config_path: Path, fade_end: int, eps_depth_end: int) -> dict:
    """The record's edit at the resume boundary: the hash fade-in's end and
    the eps-depth anneal's end in the run's config.yml. Returns the old and
    new values."""
    from nersemble_tpu_torch.config import TrainConfig
    config = TrainConfig.load(config_path)
    model = config.model
    edit = {"window_hash_encodings_end": [model.window_hash_encodings_end, fade_end],
            "eps_depth_end_step": [model.eps_depth_end_step, eps_depth_end]}
    model.window_hash_encodings_end = fade_end
    model.eps_depth_end_step = eps_depth_end
    config.save(config_path)
    return edit


def run_record(root: Path, device, schedule_steps: int = SCHEDULE_STEPS,
               resume_at: int = RESUME_AT, end: int = END,
               eval_every: int = EVAL_EVERY, n_tables: int = N_TABLES,
               fade_end: int = FADE_END, eps_depth_end: int = EPS_DEPTH_END) -> dict:
    from nersemble_tpu_torch.scripts import dynamic_forensics, quality_benchmark, trained_scene

    data, models = str(root / "data"), str(root / "models")
    start = time.time()
    # the schedules of ``schedule_steps``, ended after step ``resume_at``
    leg1 = quality_benchmark.run("dynamic", schedule_steps, data, models, eval_every,
                                 n_tables=n_tables, device=device,
                                 extra_args=["--max-num-iterations", str(resume_at + 1)])
    run_dir = Path(leg1["run_dir"])
    edit = compress_schedule(run_dir / "config.yml", fade_end, eps_depth_end)
    print(f"[record] leg 1 to step {resume_at} in {leg1['wall_clock_s']} s; "
          f"config.yml compressed {edit}", flush=True)
    leg2 = quality_benchmark.run("dynamic", end, data, models, eval_every,
                                 n_tables=n_tables, resume_run=run_dir.name,
                                 device=device)
    with trained_scene.roots(root):
        background = trained_scene.background_psnr(run_dir.name, device)
        forensics = dynamic_forensics.run(run_dir.name, device=device)
    ms = trained_scene.logged_ms_per_step(run_dir)
    return {"run": run_dir.name, "legs_s": [leg1["wall_clock_s"], leg2["wall_clock_s"]],
            "seconds": time.time() - start, "schedule_edit": edit,
            "eval_curve": leg2["eval_curve"], "n_resumes": leg2["n_resumes"],
            "final_train_psnr": leg2["final_train_psnr"],
            "background_psnr": background,
            "ms_per_step_median": sorted(ms)[len(ms) // 2] if ms else None,
            "checkpoint_digest": trained_scene.checkpoint_digest(run_dir),
            "forensics": forensics, "device": leg2["device"],
            "power_limit": leg2["power_limit"]}


def curve_beside_record(curve: list) -> list:
    """(step, port PSNR, record PSNR or None) of each eval, the last branch
    of a step superseding the earlier ones."""
    latest = {}
    for point in curve:
        latest[point["step"]] = point["eval_psnr"]
    return [(step, psnr, RECORD_PSNR.get(step)) for step, psnr in sorted(latest.items())]


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", type=Path, default=None,
                    help="capture and run go here, and stay (default: a new "
                         "temporary directory)")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the result JSON here")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the run (default: the GPU)")
    return ap


def main(argv=None, **sizes) -> dict:
    """``sizes``: ``run_record``'s step counts, for a rehearsal at a tiny
    size (the CLI runs the record's)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    root = args.root or Path(tempfile.mkdtemp(prefix="nersemble_dynamic_record_"))
    result = run_record(root, device, **sizes)
    from nersemble_tpu_torch.scripts import dynamic_forensics
    dynamic_forensics.print_report(result["forensics"])
    for step, psnr, record in curve_beside_record(result["eval_curve"]):
        print(f"[record] step {step:5d}: eval PSNR {psnr:.3f}"
              + ("" if record is None else f"  (JAX record {record:.3f})"))
    print(f"[record] an all-background image: {result['background_psnr']:.3f} dB; "
          f"median {result['ms_per_step_median']} ms/step over the logged intervals; "
          f"{result['device']} at {result['power_limit']}; last checkpoint's SHA-256 "
          f"{result['checkpoint_digest']}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=2))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
