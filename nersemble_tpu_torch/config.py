"""Model and optimizer configuration dataclasses (subset of nersemble_tpu.config).

Same class names, field names and defaults as the JAX package's
``nersemble_tpu/config.py`` so a config can be carried across field by field
(tests/test_torch_imports.py checks the defaults). No YAML: the port's
package must import without ``yaml``. The reasoning behind each sampling
lever is documented once, in the JAX config.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class HashEncodingConfig:
    """One multiresolution hash encoding."""

    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.4472692012786865
    interpolation: str = "Linear"


@dataclass
class HashEnsembleConfig:
    """Ensemble of hash encodings blended by a per-timestep latent code."""

    n_hash_encodings: int = 32
    hash_encoding: HashEncodingConfig = field(default_factory=HashEncodingConfig)
    disable_initial_hash_ensemble: bool = False
    use_soft_transition: bool = False


@dataclass
class SE3DeformationFieldConfig:
    """SE(3) warp field."""

    n_freq_pos: int = 7
    warp_code_dim: int = 128
    mlp_num_layers: int = 6
    mlp_layer_width: int = 128
    skip_connections: Tuple[int, ...] = (4,)


@dataclass
class SamplingConfig:
    """Fixed-shape occupancy-grid ray marching and its eval levers."""

    max_samples_per_ray: int = 256
    max_candidates_per_ray: int = 1024  # -1: auto-span the scene box
    global_budget_fraction: float = 1.0
    adaptive_budget: bool = True
    adaptive_budget_headroom: float = 1.15
    adaptive_budget_interval: int = 500
    eval_coarse_prefilter: bool = True
    eval_prefilter_stride: int = 8
    eval_fine_candidates: int = 512
    eval_max_samples_per_ray: int = -1
    eval_early_stop_trans: float = 1e-4
    eval_termination_probe_stride: int = 4
    eval_probe_stride: int = 4
    eval_ray_packing: bool = True
    adaptive_budget_max_chunks: int = 1


@dataclass
class ModelConfig:
    """Dynamic-NeRF model config."""

    n_timesteps: int = 1
    latent_dim_time: int = 32
    spherical_harmonics_degree: int = 0

    use_hash_ensemble: bool = False
    hash_ensemble: Optional[HashEnsembleConfig] = None

    use_deformation_field: bool = False
    deformation_field: Optional[SE3DeformationFieldConfig] = None
    use_separate_deformation_time_embedding: bool = True

    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_levels: int = 16
    base_resolution: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    use_appearance_embedding: bool = False
    appearance_embedding_dim: int = 32
    num_images: int = 0

    window_deform_begin: int = 0
    window_deform_end: int = 0
    window_hash_encodings_begin: int = 0
    window_hash_encodings_end: int = 1

    # per-sample chunk cap of the deform + field pipeline (-1: no chunking)
    max_n_samples_per_batch: int = 2 ** 16

    near_plane: float = 0.2
    far_plane: float = 1e3
    render_step_size: float = 0.011
    cone_angle: float = 0.0
    alpha_thre: float = 1e-2
    early_stop_eps: float = 0.0
    occ_thre: float = 1e-2
    disable_occupancy_grid: bool = False
    occupancy_grid_ema_decay: float = 0.95
    occupancy_grid_warmup_steps: int = 256
    grid_resolution: int = 128
    grid_levels: int = 1
    background_color: str = "white"
    sampling: SamplingConfig = field(default_factory=SamplingConfig)

    use_view_frustum_culling: bool = False
    view_frustum_culling: int = 2

    scene_box: List[List[float]] = field(
        default_factory=lambda: [[-2.5, -2.0, -2.5], [2.5, 3.0, 2.0]])

    use_masked_rgb_loss: bool = False
    alpha_mask_threshold: float = 0.5
    lambda_alpha_loss: float = 0.0
    lambda_empty_loss: float = 0.0
    lambda_near_loss: float = 0.0
    lambda_depth_loss: float = 0.0
    lambda_dist_loss: float = 0.0
    eps_depth_initial: float = 0.9
    eps_depth_final: float = 0.01
    eps_depth_begin_step: int = 0
    eps_depth_end_step: int = 10000
    dist_loss_max_rays: int = 5000

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    table_dtype: str = "bfloat16"
    use_fused_mlp: bool = True
    shard_hash_tables: bool = False


@dataclass
class OptimizerConfig:
    """Adam + StepLR of one parameter group."""

    lr: float = 5e-3
    eps: float = 1e-15
    weight_decay: float = 0.0
    scheduler_step_size: int = 20000
    scheduler_gamma: float = 0.8


def default_optimizers() -> Dict[str, OptimizerConfig]:
    """The three groups of ``TrainConfig.optimizers`` in the JAX package."""
    return {
        "fields": OptimizerConfig(lr=5e-3, scheduler_gamma=0.8),
        "deformation_field": OptimizerConfig(lr=1e-3, scheduler_gamma=0.5),
        "embeddings": OptimizerConfig(lr=5e-3, scheduler_gamma=0.8),
    }


def flagship_model_config(tiny: bool = False) -> ModelConfig:
    """The flagship model (32-table ensemble + 6x128 SE(3) stem), or its
    tiny test-size cut. Equal, field by field, to the JAX package's
    ``__graft_entry__._flagship_model_config``."""
    if tiny:
        hash_cfg = HashEncodingConfig(n_levels=4, n_features_per_level=2,
                                      log2_hashmap_size=10, base_resolution=4,
                                      per_level_scale=1.5)
        n_enc, latent, warp = 8, 8, 16
        layers, width = 2, 16
        sampling = SamplingConfig(max_samples_per_ray=16,
                                  max_candidates_per_ray=-1)
        grid_res = 16
    else:
        hash_cfg = HashEncodingConfig()
        n_enc, latent, warp = 32, 32, 128
        layers, width = 6, 128
        sampling = SamplingConfig(max_samples_per_ray=256,
                                  max_candidates_per_ray=-1,
                                  global_budget_fraction=0.125)
        grid_res = 128

    return ModelConfig(
        n_timesteps=8,
        latent_dim_time=latent,
        use_hash_ensemble=True,
        hash_ensemble=HashEnsembleConfig(
            n_hash_encodings=n_enc, hash_encoding=hash_cfg,
            disable_initial_hash_ensemble=True, use_soft_transition=True),
        use_deformation_field=True,
        deformation_field=SE3DeformationFieldConfig(
            warp_code_dim=warp, mlp_num_layers=layers, mlp_layer_width=width),
        grid_resolution=grid_res,
        render_step_size=0.011, near_plane=0.2, far_plane=1e3,
        sampling=sampling,
        max_n_samples_per_batch=2 ** 16 if tiny else 98304,
        use_masked_rgb_loss=True, alpha_mask_threshold=0.0,
        lambda_alpha_loss=1e-2, lambda_near_loss=1e-4, lambda_empty_loss=1e-2,
        lambda_depth_loss=1e-4, lambda_dist_loss=1e-4,
        window_deform_end=20000, window_hash_encodings_begin=40000,
        window_hash_encodings_end=80000,
    )
