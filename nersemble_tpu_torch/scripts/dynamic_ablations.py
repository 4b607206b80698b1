"""The dynamic quality run and its ablations, one configuration a process.

``--variant as-is`` is ``trained_scene.py --mode dynamic``'s quality run
(16 tables, the SE(3) field, 16 timesteps, the schedules compressed to
``--steps``); ``no-deformation`` drops the deformation field, and
``single-grid`` takes the single grid in place of the hash ensemble. Each
prints its eval curve beside the PSNR of an all-background image on the
same views, the SHA-256 of its last checkpoint and that checkpoint's
forensics (``dynamic_forensics.py``); the last line is one JSON object.
Runs on the GPU unless ``--device cpu``.

Usage:
    python -m nersemble_tpu_torch.scripts.dynamic_ablations --variant as-is --steps 1500
"""

import argparse
import json
import tempfile
from pathlib import Path

from nersemble_tpu_torch.utils.device import resolve_device

VARIANTS = {"as-is": [], "no-deformation": ["--no-use-deformation-field"],
            "single-grid": ["--no-use-hash-ensemble"]}


def run_variant(variant: str, steps: int, eval_every: int, root: Path, device) -> dict:
    from nersemble_tpu_torch.scripts import dynamic_forensics, quality_benchmark, trained_scene

    quality = quality_benchmark.run("dynamic", steps, str(root / "data"),
                                    str(root / "models"), eval_every, device=device,
                                    extra_args=VARIANTS[variant])
    run_dir = Path(quality["run_dir"])
    with trained_scene.roots(root):
        background = trained_scene.background_psnr(run_dir.name, device)
        forensics = dynamic_forensics.run(run_dir.name, device=device)
    return {"variant": variant, "steps": steps, "run": run_dir.name,
            "eval_curve": [(p["step"], p["eval_psnr"]) for p in quality["eval_curve"]],
            "background_psnr": background, "wall_clock_s": quality["wall_clock_s"],
            "checkpoint_digest": trained_scene.checkpoint_digest(run_dir),
            "forensics": forensics, "device": quality["device"],
            "power_limit": quality["power_limit"]}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", choices=sorted(VARIANTS), default="as-is")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--root", type=Path, default=None,
                    help="capture and run go here, and stay (default: a new "
                         "temporary directory)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the run (default: the GPU)")
    return ap


def main(argv=None) -> dict:
    from nersemble_tpu_torch.scripts import dynamic_forensics

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    root = args.root or Path(tempfile.mkdtemp(prefix="nersemble_dynamic_ablation_"))
    result = run_variant(args.variant, args.steps, args.eval_every, root, device)
    dynamic_forensics.print_report(result["forensics"])
    print(f"[ablation] {args.variant}: eval PSNR by step {result['eval_curve']}, an "
          f"all-background image {result['background_psnr']:.3f} dB; "
          f"{result['wall_clock_s']} s on {result['device']} at {result['power_limit']}; "
          f"last checkpoint's SHA-256 {result['checkpoint_digest']}", flush=True)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
