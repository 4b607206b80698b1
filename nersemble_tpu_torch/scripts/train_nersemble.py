"""Train CLI of the port (nersemble_tpu/scripts/train_nersemble.py's flags,
defaults and config tree, plus ``--device`` and ``--dist-backend``).

Assembles the full TrainConfig tree, allocates a NERS-XXX run folder (or
reopens one with ``--resume-run``: a run either package wrote), saves
config.yml, and runs the trainer's loop on the GPU unless ``--device cpu``.
``--vis viewer`` serves the live viewer (``--viewer-port``) between steps.

``--disable-occupancy-grid`` marches densely (README.md:100-104 of the
reference trains sequence 97 so): every step inside the scene box is a
sample. Unless given, ``--max-samples-per-ray`` is then the candidate
comb's own box-spanning count, so that no ray stops inside the box, and
``--global-budget-fraction`` 1.0: each step evaluates all of its valid
samples and no others (``NeRSembleModel.evaluates_valid_samples``).

``--data-axis-size N`` trains over N ranks, one card each (-1, the default:
every visible card), the JAX mesh's data axis: it starts the N processes
itself unless torchrun started them (``torchrun --nproc-per-node N -m
nersemble_tpu_torch.scripts.train_nersemble ...``). ``--dist-backend``
(nccl or gloo; by default nccl where each rank has a card of its own, else
gloo) joins them; only rank 0 writes the
run folder. ``--vis viewer`` over several ranks: rank 0 runs the server and
every rank renders each request between steps (viewer/server.py
``serve_over_ranks``).

Usage:
    python -m nersemble_tpu_torch.scripts.train_nersemble <participant_id> <sequence_name> [flags]
"""

import argparse
import sys

from nersemble_tpu_torch.config import (
    DataConfig,
    HashEncodingConfig,
    HashEnsembleConfig,
    ModelConfig,
    OptimizerConfig,
    SamplingConfig,
    SE3DeformationFieldConfig,
    TrainConfig,
)
from nersemble_tpu_torch.data.dataparser import scene_box
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.model_manager import NeRSembleModelFolder
from nersemble_tpu_torch.ops.sampling import spanning_comb
from nersemble_tpu_torch.parallel import launch
from nersemble_tpu_torch.parallel import mesh as mesh_lib
from nersemble_tpu_torch.utils.device import resolve_device


class _Given(argparse.Action):
    """Stores the flag's value and notes that it was given (``given``)."""

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, values)
        namespace.given = getattr(namespace, "given", frozenset()) | {self.dest}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("participant_id", type=int)
    p.add_argument("sequence_name", type=str)
    p.add_argument("--name", type=str, default=None)
    # "viewer" = the live web viewer (reference: nerfstudio's --vis viewer,
    # train_nersemble.py:56), served between training steps; metrics still
    # go to csv alongside it
    p.add_argument("--vis", type=str, default="csv",
                   choices=["csv", "tensorboard", "none", "viewer"])
    p.add_argument("--viewer-port", type=int, default=7007)

    # sequence
    p.add_argument("--start-timestep", type=int, default=0)
    p.add_argument("--n-timesteps", type=int, default=-1)
    p.add_argument("--skip-timesteps", type=int, default=1)
    p.add_argument("--max-cached-images", type=int, default=10000)

    # learning rates
    p.add_argument("--lr-main", type=float, default=5e-3)
    p.add_argument("--lr-deformation-field", type=float, default=1e-3)
    p.add_argument("--lr-embeddings", type=float, default=5e-3)

    # losses
    p.add_argument("--lambda-alpha-loss", type=float, default=1e-2)
    p.add_argument("--lambda-near-loss", type=float, default=1e-4)
    p.add_argument("--lambda-empty-loss", type=float, default=1e-2)
    p.add_argument("--lambda-depth-loss", type=float, default=1e-4)
    p.add_argument("--lambda-dist-loss", type=float, default=1e-4)

    # schedulers
    p.add_argument("--window-hash-encodings-begin", type=int, default=40000)
    p.add_argument("--window-hash-encodings-end", type=int, default=80000)
    p.add_argument("--window-deform-begin", type=int, default=0)
    p.add_argument("--window-deform-end", type=int, default=20000)

    # hash ensemble
    p.add_argument("--use-hash-ensemble", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--n-hash-encodings", type=int, default=32)
    p.add_argument("--latent-dim-time", type=int, default=32)

    # deformation field
    p.add_argument("--use-deformation-field", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--latent-dim-time-deform", type=int, default=128)
    p.add_argument("--mlp-num-layers", type=int, default=6)
    p.add_argument("--mlp-layer-width", type=int, default=128)

    # logging / eval cadence
    p.add_argument("--steps-per-eval-image", type=int, default=20000)
    p.add_argument("--steps-per-eval-all-images", type=int, default=50000)
    p.add_argument("--max-num-iterations", type=int, default=300001)

    # ray marching
    p.add_argument("--cone-angle", type=float, default=0.0)
    p.add_argument("--alpha-thre", type=float, default=1e-2)
    p.add_argument("--early-stop-eps", type=float, default=0.0,
                   help="terminate rays once transmittance < eps (reference "
                        "trains with 0: train_nersemble.py:192)")
    p.add_argument("--occ-thre", type=float, default=1e-2)
    p.add_argument("--n-train-rays", type=int, default=4096)
    p.add_argument("--grid-levels", type=int, default=1)
    p.add_argument("--disable-occupancy-grid", action="store_true")
    # sampling defaults == the benched/quality-proven configuration
    # (bench.py, __graft_entry__.py, scripts/quality_benchmark.py): S=256
    # slots (the reference train default — the S=64 cap measurably dropped
    # 68% of valid samples, PERF.md round 2b), candidates auto-sized to span
    # the scene box, budget fraction 0.125 (131,072 samples at R=4096).
    p.add_argument("--max-samples-per-ray", type=int, default=256, action=_Given)
    p.add_argument("--max-candidates-per-ray", type=int, default=-1,
                   help="-1 auto-sizes to span the scene-box diagonal")
    p.add_argument("--global-budget-fraction", type=float, default=0.125,
                   action=_Given,
                   help="evaluate only this fraction of the R*S sample slots "
                        "per batch (global compaction; 1.0 disables)")
    p.add_argument("--max-n-samples-per-batch", type=int, default=98304,
                   help="sample-chunk size bounding HBM (reference: "
                        "train_nersemble.py:90). 98,304 lets the steady-state "
                        "adapted budget run as ONE chunk (PERF.md round 3b: "
                        "355 vs 388 ms/step over 2 chunks); larger budgets "
                        "split into equal chunks under this cap")
    p.add_argument("--adaptive-budget-max-chunks", type=int, default=1,
                   help="cap on ADAPTIVE budget growth past the formula "
                        "budget, in units of max-n-samples-per-batch chunks "
                        "(config.SamplingConfig.adaptive_budget_max_chunks). "
                        "The early dynamic fade-in marches ~2.4x the formula "
                        "budget before the grid carves; 3 lets the budget "
                        "grow to cover it instead of dropping ~40%% of "
                        "samples through the first interval")
    p.add_argument("--eps-depth-initial", type=float, default=0.9)
    p.add_argument("--eps-depth-final", type=float, default=0.01)
    p.add_argument("--eps-depth-end-step", type=int, default=10000)
    p.add_argument("--steps-per-eval-batch", type=int, default=500)

    # view-frustum culling
    p.add_argument("--use-view-frustum-culling",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--view-frustum-culling", type=int, default=2)

    # resume
    p.add_argument("--resume-run", type=str, default=None)
    p.add_argument("--resume-checkpoint", type=int, default=None)

    # architecture scale (defaults = paper config; lower for smoke runs)
    p.add_argument("--num-levels", type=int, default=16)
    p.add_argument("--log2-hashmap-size", type=int, default=19)
    p.add_argument("--max-res", type=int, default=2048)
    p.add_argument("--grid-resolution", type=int, default=128)
    p.add_argument("--steps-per-save", type=int, default=50000)

    # TPU specifics
    p.add_argument("--data-axis-size", type=int, default=-1,
                   help="ranks on the data-parallel axis, one card each "
                        "(-1: every visible card; one on the CPU)")
    p.add_argument("--dist-backend", type=str, default=None,
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend over several ranks "
                        "(default: nccl where each rank has a card of its "
                        "own, else gloo)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default: the GPU)")
    return p


def dense_sampling(args, scale_factor: float, render_step_size: float,
                   near_plane: float):
    """(samples per ray, budget fraction) of the run: the flags', or, with
    the occupancy grid off and the flag not given, the comb that spans the
    participant's scene box (the auto-sized candidate count) and every
    valid sample."""
    S, frac = args.max_samples_per_ray, args.global_budget_fraction
    if args.disable_occupancy_grid:
        given = getattr(args, "given", frozenset())
        if "max_samples_per_ray" not in given:
            S = spanning_comb(scene_box(args.participant_id, scale_factor),
                              args.grid_levels, render_step_size, args.cone_angle,
                              near_plane)
        if "global_budget_fraction" not in given:
            frac = 1.0
    return S, frac


def build_config(args, run_name: str, output_dir: str) -> TrainConfig:
    scale_factor = 9.0
    render_step_size = 0.011 * scale_factor / 9.0
    near_plane = 0.2 * scale_factor / 9.0
    samples_per_ray, budget_fraction = dense_sampling(
        args, scale_factor, render_step_size, near_plane)

    use_sh = 0  # reference train config leaves SH degree at its default 0
    model = ModelConfig(
        n_timesteps=args.n_timesteps,
        latent_dim_time=args.latent_dim_time,
        spherical_harmonics_degree=use_sh,
        use_hash_ensemble=args.use_hash_ensemble,
        hash_ensemble=HashEnsembleConfig(
            n_hash_encodings=args.n_hash_encodings,
            hash_encoding=HashEncodingConfig(
                n_levels=args.num_levels,
                log2_hashmap_size=args.log2_hashmap_size),
            disable_initial_hash_ensemble=True,
            use_soft_transition=True,
        ) if args.use_hash_ensemble else None,
        use_deformation_field=args.use_deformation_field,
        use_separate_deformation_time_embedding=True,
        deformation_field=SE3DeformationFieldConfig(
            warp_code_dim=args.latent_dim_time_deform,
            mlp_num_layers=args.mlp_num_layers,
            mlp_layer_width=args.mlp_layer_width,
        ) if args.use_deformation_field else None,
        window_hash_encodings_begin=args.window_hash_encodings_begin,
        window_hash_encodings_end=args.window_hash_encodings_end,
        window_deform_begin=args.window_deform_begin,
        window_deform_end=args.window_deform_end,
        # ray marching (reference: train_nersemble.py:186-197)
        render_step_size=render_step_size,
        near_plane=near_plane,
        far_plane=1e3 * scale_factor / 9.0,
        cone_angle=args.cone_angle,
        alpha_thre=args.alpha_thre,
        occ_thre=args.occ_thre,
        early_stop_eps=args.early_stop_eps,
        background_color="white",
        num_levels=args.num_levels,
        log2_hashmap_size=args.log2_hashmap_size,
        max_res=args.max_res,
        grid_resolution=args.grid_resolution,
        grid_levels=args.grid_levels,
        disable_occupancy_grid=args.disable_occupancy_grid,
        sampling=SamplingConfig(
            max_samples_per_ray=samples_per_ray,
            max_candidates_per_ray=args.max_candidates_per_ray,
            global_budget_fraction=budget_fraction,
            adaptive_budget_max_chunks=args.adaptive_budget_max_chunks,
        ),
        max_n_samples_per_batch=args.max_n_samples_per_batch,
        eps_depth_initial=args.eps_depth_initial,
        eps_depth_final=args.eps_depth_final,
        eps_depth_end_step=args.eps_depth_end_step,
        use_masked_rgb_loss=True,
        alpha_mask_threshold=0.0,
        lambda_alpha_loss=args.lambda_alpha_loss,
        lambda_near_loss=args.lambda_near_loss,
        lambda_empty_loss=args.lambda_empty_loss,
        lambda_depth_loss=args.lambda_depth_loss,
        lambda_dist_loss=args.lambda_dist_loss,
        use_view_frustum_culling=args.use_view_frustum_culling,
        view_frustum_culling=args.view_frustum_culling,
    )

    data = DataConfig(
        participant_id=args.participant_id,
        sequence_name=args.sequence_name,
        start_timestep=args.start_timestep,
        n_timesteps=args.n_timesteps,
        skip_timesteps=args.skip_timesteps,
        scale_factor=scale_factor,
        use_alpha_maps=args.lambda_alpha_loss > 0,
        use_depth_maps=(args.lambda_empty_loss > 0 or args.lambda_near_loss > 0
                        or args.lambda_depth_loss > 0),
        use_view_frustum_culling=args.use_view_frustum_culling,
        train_num_rays_per_batch=args.n_train_rays,
        eval_num_rays_per_batch=1024,
        train_num_images_to_sample_from=24,
        train_num_times_to_repeat_images=20,
        max_cached_items=args.max_cached_images,
    )

    return TrainConfig(
        run_name=run_name,
        experiment_name=run_name,
        output_dir=output_dir,
        max_num_iterations=args.max_num_iterations,
        steps_per_eval_batch=args.steps_per_eval_batch,
        steps_per_eval_image=args.steps_per_eval_image,
        steps_per_eval_all_images=args.steps_per_eval_all_images,
        steps_per_save=args.steps_per_save,
        save_only_latest_checkpoint=True,
        vis=args.vis,
        viewer_port=args.viewer_port,
        data=data,
        model=model,
        optimizers={
            "fields": OptimizerConfig(lr=args.lr_main, scheduler_step_size=20000,
                                      scheduler_gamma=0.8),
            "deformation_field": OptimizerConfig(lr=args.lr_deformation_field,
                                                 scheduler_step_size=20000,
                                                 scheduler_gamma=0.5),
            "embeddings": OptimizerConfig(lr=args.lr_embeddings,
                                          scheduler_step_size=20000,
                                          scheduler_gamma=0.8),
        },
    )


def main(argv=None, step_hook=None):
    """Parse ``argv``, build or reopen the run, train; returns rank 0's last
    logged scalars. ``step_hook``: ``NeRSembleTrainer.step_hook`` of the run
    (for instrumentation; one process only)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # no GPU: raise before a run folder is made
    n = mesh_lib.axis_size(args.data_axis_size, device)
    if step_hook is not None and n > 1 and not launch.under_torchrun():
        raise ValueError("step_hook runs in one process; --data-axis-size "
                         f"{n} starts {n}")
    return launch.run_cli("nersemble_tpu_torch.scripts.train_nersemble", argv, device,
                          args.data_axis_size, step_hook, backend=args.dist_backend)


def run(argv, mesh=None, step_hook=None):
    """The run of ``argv`` on this rank (``mesh`` None: one process)."""
    args = build_parser().parse_args(argv)
    chief = mesh is None or mesh.rank == 0
    model_folder = NeRSembleModelFolder()
    if args.resume_run:
        manager = model_folder.open_run(args.resume_run)
        config = manager.load_config()
        config.load_dir = manager.get_checkpoint_folder()
        config.load_step = args.resume_checkpoint
        config.max_num_iterations = args.max_num_iterations
    else:
        name = model_folder.new_run(name=args.name).get_run_name() if chief else None
        if mesh is not None:
            name = mesh.broadcast_object(name)
        manager = model_folder.open_run(name)
        config = build_config(args, manager.get_run_name(),
                              model_folder.get_location())
        config.parallel.data_axis_size = args.data_axis_size

    device = mesh_lib.local_device(args.device, mesh) if mesh else args.device
    trainer = NeRSembleTrainer.from_train_config(config, model_manager=manager,
                                                 device=device, mesh=mesh)
    trainer.step_hook = step_hook
    # save config AFTER trainer setup (it fills in n_timesteps/scene_box)
    if chief:
        manager.save_config(config)
        ranks = "" if mesh is None else f", {mesh.size} ranks ({mesh.backend}), " \
            f"table {trainer.table_layout}"
        print(f"[nersemble-torch] run {manager.get_run_name()} "
              f"({config.data.n_timesteps} timesteps, "
              f"{trainer.train_outputs.n_images} train images, {trainer.device}"
              f"{ranks})")
    try:
        result = trainer.train()
    finally:
        trainer.writer.close()
        if trainer.viewer is not None:
            trainer.viewer.close()
    if chief:
        print(f"[nersemble-torch] DONE step={result.get('step')} "
              f"loss={result.get('loss'):.4f} psnr={result.get('train_psnr', 0):.2f}")
    return result


def entrypoint():
    main()


if __name__ == "__main__":
    entrypoint()
