"""Evaluate CLI of the port: render hold-out views, compute NVS metrics,
persist artifacts (nersemble_tpu/scripts/evaluate_nersemble.py's flags,
defaults and artifacts, plus ``--device``).

Reference: scripts/evaluate/evaluate_nersemble.py:22-321. Renders the 4
evaluation cameras at ``max_eval_timesteps`` evenly spaced timesteps (or every
``skip_timesteps``-th with -1), computes PSNR/SSIM/MSE (+ LPIPS when VGG
weights are available, + per-camera JOD from pyfvvdp or the vendored
pipeline, both null otherwise) raw and alpha-masked on the trainer's
device (JOD on the host), writes per-frame PNGs named
``frame_{original_timestep:05d}/cam_{global_cam_id}.png`` and
``evaluation_result.json`` (per_cam keyed by camera serial) in the
reference's evaluation folder layout. Runs on the GPU unless ``--device
cpu``; reads run folders written by either package.

Like the JAX CLIs, it runs on the ranks of the run's
``config.parallel.data_axis_size`` (-1: every visible card, one rank on the
CPU; parallel/launch.py ``run_cli``: spawned here, or under torchrun): the
table in the layout ``config.parallel`` chooses, each rank rendering its
share of every chunk. Rank 0 alone computes the metrics on whole frames,
runs JOD, prints and writes.

Usage:
    python -m nersemble_tpu_torch.scripts.evaluate_nersemble NERS-XXX [checkpoint] [flags]
"""

import argparse
import sys
import time
from collections import defaultdict
from statistics import mean
from typing import Optional

import numpy as np

from nersemble_tpu_torch.constants import SERIALS
from nersemble_tpu_torch.model_manager import (
    NeRSembleModelFolder,
    NVSEvaluationMetrics,
    NVSEvaluationMetricsBundle,
    NVSEvaluationResult,
)
from nersemble_tpu_torch.parallel import launch
from nersemble_tpu_torch.parallel import mesh as mesh_lib
from nersemble_tpu_torch.utils import metrics as M
from nersemble_tpu_torch.utils.device import resolve_device

METRIC_KEYS = ("psnr", "ssim", "lpips", "mse", "jod")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_name", type=str)
    p.add_argument("checkpoint", type=int, nargs="?", default=None)
    p.add_argument("--n-rays-eval", type=int, default=2 ** 13)
    p.add_argument("--max-eval-timesteps", type=int, default=15)
    p.add_argument("--skip-timesteps", type=int, default=None)
    p.add_argument("--use-occupancy-grid-filtering",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--occupancy-grid-filtering-threshold", type=float, default=0.05)
    p.add_argument("--occupancy-grid-filtering-sigma-erosion", type=float, default=7)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default: the GPU)")
    return p


def select_eval_indices(entries, skip_timesteps: Optional[int]):
    """Eval-view subset for --skip-timesteps: the reference keeps frames
    whose ON-DISK frame number satisfies ``timestep % skip_timesteps == 0``
    (reference: evaluate_nersemble.py:139-141) — NOT every k-th evaluated
    index (the two diverge whenever start_timestep != 0 or the dataparser
    skip != 1)."""
    if skip_timesteps is None or skip_timesteps <= 1:
        return list(range(len(entries)))
    return [i for i, e in enumerate(entries)
            if e.original_timestep % skip_timesteps == 0]


def open_run(args):
    """(manager, config) of ``args.run_name``, set to load its checkpoints
    with no metrics writer; raises first when ``args.device`` is a GPU the
    machine lacks."""
    resolve_device(args.device)
    manager = NeRSembleModelFolder().open_run(args.run_name)
    config = manager.load_config()
    config.load_dir = manager.get_checkpoint_folder()
    config.vis = "none"
    return manager, config


def eval_trainer(config, manager, args, mesh=None):
    """The eval-only trainer of a run on ``args.device`` (this rank's card
    of ``mesh``), with the occupancy CC filter ANDed into its grid mask
    when ``args.use_occupancy_grid_filtering`` (the evaluate, render and
    view CLIs)."""
    from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer

    device = mesh_lib.local_device(args.device, mesh) if mesh else args.device
    trainer = NeRSembleTrainer.from_train_config(
        config, model_manager=manager, eval_only=True, device=device, mesh=mesh)

    if args.use_occupancy_grid_filtering and not config.model.disable_occupancy_grid:
        from nersemble_tpu_torch.utils.connected_components import \
            filter_occupancy_grid_mask
        mask = filter_occupancy_grid_mask(
            trainer.grid_occs.cpu().numpy(), config.model.grid_resolution,
            threshold=args.occupancy_grid_filtering_threshold,
            sigma_erosion=args.occupancy_grid_filtering_sigma_erosion)
        trainer.apply_grid_mask(mask)
        if trainer.is_chief:
            print(f"[nersemble-torch] occupancy CC filter kept {int(mask.sum())} "
                  f"of {mask.size} grid cells")
    return trainer


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    _, config = open_run(args)
    result = launch.run_cli("nersemble_tpu_torch.scripts.evaluate_nersemble", argv,
                            args.device, config.parallel.data_axis_size)
    return NVSEvaluationResult.from_dict(result)


def run(argv, mesh=None):
    """The evaluation of ``argv`` on this rank (``mesh`` None: one
    process); rank 0's result as a dict, None on the other ranks."""
    args = build_parser().parse_args(argv)
    manager, config = open_run(args)
    # eval view set (reference: evaluate_nersemble.py:62-66)
    config.data.max_eval_timesteps = args.max_eval_timesteps
    config.data.eval_num_rays_per_batch = args.n_rays_eval
    config.load_step = args.checkpoint
    trainer = eval_trainer(config, manager, args, mesh)
    checkpoint = trainer.start_step - 1
    chief = trainer.is_chief

    artifact_kwargs = dict(max_eval_timesteps=args.max_eval_timesteps,
                           skip_timesteps=args.skip_timesteps,
                           use_occupancy_grid_filtering=args.use_occupancy_grid_filtering)

    loader = trainer.eval_loader
    indices = select_eval_indices(trainer.eval_outputs.entries,
                                  args.skip_timesteps)

    per_cam = defaultdict(lambda: {"regular": defaultdict(list),
                                   "masked": defaultdict(list)})
    frames_pred = defaultdict(list)
    frames_gt = defaultdict(list)
    frames_pred_masked = defaultdict(list)
    frames_gt_masked = defaultdict(list)
    start = time.perf_counter()
    for image_idx in indices:
        rays = loader.image_rays(image_idx)
        rendered = trainer.render_image(rays, step=checkpoint,
                                        chunk=args.n_rays_eval)
        if not chief:  # every rank renders its share; rank 0 scores and writes
            continue
        pred = rendered["rgb"]
        gt = rays["gt_rgb"]
        alpha = rays.get("gt_alpha")
        regular, masked = M.image_metrics(pred, gt, alpha, trainer.device)
        # video-level metric: filled per camera after the loop
        regular["jod"] = masked["jod"] = None

        entry = rays["entry"]
        cam_pos = entry.cam_pos  # 0..3 within EVALUATION_CAM_IDS
        # artifacts are named by the GLOBAL cam id and the ON-DISK frame
        # number (reference: evaluate_nersemble.py:140-151)
        manager.save_evaluation_img(
            entry.cam_id, (np.clip(pred, 0, 1) * 255).round().astype(np.uint8),
            checkpoint=checkpoint, timestep=entry.original_timestep,
            **artifact_kwargs)

        # JOD frame stacks in uint8 (reference: :156-167)
        pred_u8 = (np.clip(pred, 0, 1) * 255).astype(np.uint8)
        gt_u8 = (np.clip(gt, 0, 1) * 255).astype(np.uint8)
        frames_pred[cam_pos].append(pred_u8)
        frames_gt[cam_pos].append(gt_u8)
        if alpha is not None:
            a_u8 = (np.clip(alpha, 0, 1) * 255).astype(np.uint8)
            frames_pred_masked[cam_pos].append(
                M.perform_alpha_blending(pred_u8, a_u8))
            frames_gt_masked[cam_pos].append(
                M.perform_alpha_blending(gt_u8, a_u8))

        for key, value in regular.items():
            if value is not None:
                per_cam[cam_pos]["regular"][key].append(value)
        for key, value in masked.items():
            if value is not None:
                per_cam[cam_pos]["masked"][key].append(value)
        print(f"[eval] cam {entry.cam_id} frame {entry.original_timestep}: "
              f"psnr={regular['psnr']:.2f} ssim={regular['ssim']:.3f}")
    image_s = time.perf_counter() - start
    if not chief:
        return None

    # JOD video metric per camera (reference: evaluate_nersemble.py:206-240).
    # Evaluator resolution (utils/jod.py): real pyfvvdp if importable, else
    # the vendored FovVideoVDP-class pipeline (utils/fvvdp.py — coarsely
    # calibrated, framework-internally comparable), else null.
    from nersemble_tpu_torch.utils.jod import (evaluation_fps,
                                               get_jod_evaluator, jod_score)
    start = time.perf_counter()
    evaluator = get_jod_evaluator()
    if evaluator is not None:
        fps = evaluation_fps(config.data.skip_timesteps,
                             config.data.n_timesteps,
                             args.max_eval_timesteps, args.skip_timesteps)
        for cam_pos in frames_pred:
            jod = jod_score(evaluator, np.stack(frames_pred[cam_pos]),
                            np.stack(frames_gt[cam_pos]), fps)
            per_cam[cam_pos]["regular"]["jod"].append(jod)
            if cam_pos in frames_pred_masked:
                jod_m = jod_score(evaluator,
                                  np.stack(frames_pred_masked[cam_pos]),
                                  np.stack(frames_gt_masked[cam_pos]), fps)
                per_cam[cam_pos]["masked"]["jod"].append(jod_m)
    jod_s = time.perf_counter() - start
    print(f"[eval] {len(indices)} images rendered and scored in {image_s:.2f} s "
          f"({image_s / max(len(indices), 1):.3f} s/image); JOD "
          f"({type(evaluator).__name__}) in {jod_s:.2f} s on the host")

    def bundle(reg: dict, msk: dict) -> NVSEvaluationMetricsBundle:
        def metrics_of(d):
            return NVSEvaluationMetrics(**{k: (mean(v) if v else None)
                                           for k, v in d.items()
                                           if k in METRIC_KEYS})
        return NVSEvaluationMetricsBundle(regular=metrics_of(reg),
                                          masked=metrics_of(msk))

    def cam_key(cam_pos: int) -> str:
        """per_cam JSON keys are camera SERIALS
        (reference: evaluate_nersemble.py:287-299)."""
        cam_ids = trainer.eval_outputs.cam_ids
        return SERIALS[cam_ids[cam_pos]] if cam_pos < len(cam_ids) \
            else str(cam_pos)

    result = NVSEvaluationResult(
        mean=bundle(
            {k: sum((per_cam[c]["regular"][k] for c in per_cam), [])
             for k in METRIC_KEYS},
            {k: sum((per_cam[c]["masked"][k] for c in per_cam), [])
             for k in METRIC_KEYS}),
        per_cam={cam_key(c): bundle(per_cam[c]["regular"], per_cam[c]["masked"])
                 for c in sorted(per_cam)},
    )
    manager.save_evaluation_result(result, checkpoint=checkpoint, **artifact_kwargs)
    print(f"[eval] mean psnr={result.mean.regular.psnr:.2f} "
          f"ssim={result.mean.regular.ssim:.3f} -> "
          f"{manager.get_evaluation_result_path(checkpoint, **artifact_kwargs)}")
    return result.to_dict()


def entrypoint():
    main()


if __name__ == "__main__":
    entrypoint()
