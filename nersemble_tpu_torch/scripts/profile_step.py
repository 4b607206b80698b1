"""Component-level timing of the flagship train step on the GPU (the port of
scripts/profile_step.py).

    python -m nersemble_tpu_torch.scripts.profile_step [--rays 4096] [--iters 10]

Times each hot component alone, forward and forward+backward where it has
a backward: the march, ``hash_grid_indices``, the quad build, the blended
encode (with its build), the deformation field, ``field_density``,
``render_rays`` (eval), the full training loss and the Adam update. The
flagship config at the bench's inputs (its grid, batch and end-of-schedule
values). Per-sample components run alone at the chunk cap Nc (98,304
samples) and their forward times are also shown scaled by N/Nc, N = rays x
S. Times are CUDA-event means after two warm-up calls; a component that
fails raises.
"""

import argparse
from typing import Optional, Sequence

import torch

from nersemble_tpu_torch.bench import LRS, schedule_end
from nersemble_tpu_torch.config import flagship_model_config
from nersemble_tpu_torch.engine.optimizers import (
    fused_adam_update,
    group_of_param,
    init_adam,
)
from nersemble_tpu_torch.models.deformation import deformation_offsets
from nersemble_tpu_torch.models.field import field_density, prepare_field
from nersemble_tpu_torch.models.nersemble import NeRSembleModel
from nersemble_tpu_torch.ops.hash_encoding import (
    build_quad_table,
    hash_encode_blended,
    hash_grid_indices,
)
from nersemble_tpu_torch.ops.sampling import march_rays
from nersemble_tpu_torch.utils.bench_data import bench_batch, bench_grid
from nersemble_tpu_torch.utils.device import resolve_device
from nersemble_tpu_torch.utils.timing import cuda_time_ms, nvidia_smi
from nersemble_tpu_torch.utils.windows import sched_values

STANDALONE_CAP = 131072  # the JAX script's cap on the standalone row count


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=10)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Time the components; returns {name: ms}."""
    args = parse_args(argv)
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = flagship_model_config(tiny=False)
    n_rays = args.rays
    model = NeRSembleModel(config, device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen)
    for p in params.parameters():
        p.requires_grad_(True)
    binaries = model.binaries(bench_grid(config.grid_resolution).to(device))
    batch = bench_batch(n_rays, config.n_timesteps, config.grid_resolution, device)
    sched = sched_values(config, schedule_end(config))
    jitter = torch.rand(n_rays, generator=gen, device=device)

    S = config.sampling.max_samples_per_ray
    N = n_rays * S
    chunk = config.max_n_samples_per_batch
    Nc = min(N, chunk if chunk > 0 else N, STANDALONE_CAP)
    pos = torch.rand(Nc, 3, generator=gen, device=device) * 0.9 + 0.05
    ts = torch.randint(0, config.n_timesteps, (Nc,), generator=gen, device=device)
    code = torch.randn(Nc, config.hash_ensemble.n_hash_encodings, generator=gen,
                       device=device)
    tc_def = torch.randn(Nc, config.deformation_field.warp_code_dim, generator=gen,
                         device=device)
    levels = model.levels
    table = params.field.table
    print(f"# {nvidia_smi()}", flush=True)
    print(f"table: {tuple(table.shape)} {table.dtype} "
          f"({table.numel() * table.element_size() / 2**30:.2f} GiB)", flush=True)
    print(f"samples N = {N} ({n_rays} rays x {S} slots); standalone ops at "
          f"Nc = {Nc}", flush=True)

    results = {}

    def run(name, fn, grad=False):
        if grad:
            results[name] = cuda_time_ms(fn, args.iters, warmup=2)
        else:
            with torch.no_grad():
                results[name] = cuda_time_ms(fn, args.iters, warmup=2)

    def grads(loss, inputs):
        return torch.autograd.grad(loss, inputs, allow_unused=True)

    n_cand = model.config.sampling.max_candidates_per_ray  # auto-resolved
    run("march_rays fwd", lambda: march_rays(
        batch["origins"], batch["directions"], model.aabb_min, model.aabb_max,
        config.render_step_size, n_cand, S, binaries=binaries,
        near_plane=config.near_plane, far_plane=config.far_plane)[0].t_starts)
    run("hash_grid_indices fwd", lambda: hash_grid_indices(pos, levels)[0])
    run("build_quad_table fwd", lambda: build_quad_table(table, levels))
    run("hash_encode_blended (+build) fwd", lambda: hash_encode_blended(
        build_quad_table(table, levels), pos, code, levels, 2))
    pos_g = pos.clone().requires_grad_(True)
    code_g = code.clone().requires_grad_(True)
    run("hash_encode_blended (+build) fwd+bwd", lambda: grads(
        (hash_encode_blended(build_quad_table(table, levels), pos_g, code_g,
                             levels, 2) ** 2).sum(), (table, pos_g, code_g)), True)

    def deform(p):
        return deformation_offsets(params.deformation, p, tc_def,
                                   config.deformation_field,
                                   window_param=sched["window_deform"])
    run("deformation fwd", lambda: deform(pos))
    # with respect to the field's parameters: the warp kernels give the
    # positions no gradient (training's positions carry none)
    run("deformation fwd+bwd", lambda: grads(
        (deform(pos) ** 2).sum(), tuple(params.deformation.parameters())), True)

    def density(p):
        fp = prepare_field(params.field, config, levels)
        return field_density(fp, p, params.time_embedding[ts], config, levels,
                             model.aabb_min, model.aabb_max,
                             window_hash=sched["window_hash"])[0]
    run("field_density fwd", lambda: density(pos))
    run("field_density fwd+bwd", lambda: grads(
        (density(pos_g) ** 2).sum(),
        (*params.field.parameters(), params.time_embedding, pos_g)), True)

    run("render_rays fwd", lambda: model.render_rays(
        params, batch, binaries, sched, train=False)["rgb"])

    def loss_fwd_bwd():
        out = model.render_rays(params, batch, binaries, sched, train=True,
                                jitter=jitter)
        loss = sum(model.compute_losses(out, batch, sched, train=True).values())
        return grads(loss, list(params.parameters()))
    run("full loss fwd+bwd", loss_fwd_bwd, True)

    state = init_adam(params)
    key_to_group = group_of_param(model.param_groups(params))
    for p in params.parameters():
        p.grad = torch.ones_like(p)
    run("adam update", lambda: fused_adam_update(params, state, key_to_group, LRS))

    print(flush=True)
    scale = N / Nc
    for name, ms in results.items():
        note = f"  (x{scale:.1f} => {ms * scale:8.2f} ms at N={N})" \
            if "fwd" in name and not name.startswith(("render", "full", "march")) \
            else ""
        print(f"{name:38s} {ms:9.3f} ms{note}", flush=True)
    return results


if __name__ == "__main__":
    main()
