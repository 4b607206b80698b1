#!/usr/bin/env python3
"""Run the PyTorch port's render path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device    -- requires CUDA; prints the card and its power limit;
  2. build     -- compiles the CUDA kernels from csrc/ (nvcc, sm_90a);
  3. kernels   -- each kernel vs its plain PyTorch version at the flagship
                  shapes: the quad build (B3) on a [6,537,216, 64] bf16 table
                  must be bit-exact; the fused MLP forward (B1-fwd) on the
                  stem, base and head at 98,304 rows within the tolerance
                  stated in ops/fused_mlp.py (max error under half a bf16 ulp
                  of the largest output, mean error under 1e-5 of the mean
                  output). Times both;
  4. render    -- the flagship model (random weights from a seed, with
                  contrast added so the hash table, the time codes and the
                  warp shape the frames) renders three 550x802 frames through
                  Renderer.render_image(chunk=8192) over bench.py's synthetic
                  grid (5% random fill + the centre block), camera at
                  distance 8, 60 degree vertical view; outputs must be
                  finite, rays must hit, the three timesteps must give three
                  different frames, and both kernels' launch counters must
                  grow during this phase;
  5. profile   -- one more 550x802 frame under torch.profiler: device busy
                  share, the render path's ranges and the top kernels;
  6. reference -- a 32x24 frame of the same scene on the GPU vs the port's
                  CPU path (plain versions of both kernels; the CPU path is
                  held to the JAX package by tests/test_torch_*.py).
Then one JSON line with the kernels, and the last line
{"ok": true, "device": {...}}. Any failure raises: the exit code is non-zero
and the last line is not printed. Without a CUDA device nothing runs.
"""

import copy
import json
import subprocess
import time

import numpy as np

SEED = 0
FRAME_H, FRAME_W = 802, 550      # the reference's 3208x2200 at downscale 4
CHUNK = 8192                     # the render CLI's default --n-rays 2^13
TIMESTEPS = (0, 3, 7)
MLP_ROWS = 98304                 # the flagship sample-chunk cap
REF_H, REF_W, REF_CHUNK = 32, 24, 256
# GPU vs CPU render of the reference frame: the same plain code but for the
# two kernels (B3 bit-exact, B1-fwd summing in another order) differs by
# ~7e-6 on an H100. Swapping two quarters of the quad table moves the tiny
# config's frame by 2.6e-3 to 5e-3, so a wrong quad or encode fails this.
REF_TOL = dict(rtol=0.0, atol=1e-4)
PROFILE_RANGES = ("render:march", "render:sigma_probe", "render:field",
                  "field:hash_encode")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_time_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_frame(renderer, frame, step) -> None:
    """One frame under torch.profiler: wall time, summed kernel time (one
    stream, so kernels do not overlap) and the busy share, then the render
    path's ranges and the top kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        renderer.render_image(frame, step, chunk=CHUNK)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    events = prof.key_averages()
    # record_function ranges also show as GPU annotations: keep kernels only
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and e.key not in PROFILE_RANGES),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        log("profile", f"wall {wall_ms:.1f} ms/frame; the profiler traced no kernels")
        return
    log("profile", f"wall {wall_ms:.1f} ms/frame; kernels {busy_ms:.1f} ms/frame; "
                   f"device busy {100 * busy_ms / wall_ms:.1f}%, idle "
                   f"{100 * (1 - busy_ms / wall_ms):.1f}%")
    for e in events:
        if e.key in PROFILE_RANGES and e.device_type == DeviceType.CPU:
            log("profile", f"range {e.key:20s} calls {e.count:4d}  host "
                           f"{e.cpu_time_total / 1e3:8.1f} ms  kernels "
                           f"{e.device_time_total / 1e3:8.1f} ms "
                           f"({100 * e.device_time_total / 1e3 / busy_ms:5.1f}%)")
    for e in kernels[:12]:
        log("profile", f"{e.self_device_time_total / 1e3:8.2f} ms "
                       f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
                       f"x{e.count:<5d} {e.key[:100]}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on an NVIDIA GPU")
    from nersemble_tpu_torch.config import flagship_model_config
    from nersemble_tpu_torch.engine.renderer import Renderer
    from nersemble_tpu_torch.models.nersemble import NeRSembleModel
    from nersemble_tpu_torch.ops import cuda_lib, fused_mlp, quad_kernel
    from nersemble_tpu_torch.ops.hash_encoding import HashGridLevels
    from nersemble_tpu_torch.ops.mlp import init_mlp
    from nersemble_tpu_torch.utils.cameras import (
        add_contrast,
        pinhole_frame,
        synthetic_occupancy,
    )
    from nersemble_tpu_torch.utils.params import ParamTree
    from nersemble_tpu_torch.utils.windows import sched_values

    # ---- 1. device ----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log("device", f"{name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)

    # ---- 2. build -------------------------------------------------------------
    start = time.perf_counter()
    cuda_lib.library()
    log("build", f"kernels ready in {time.perf_counter() - start:.1f} s "
                 f"({cuda_lib.library_path().name})")
    for line in (cuda_lib.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("build", line.strip())

    # ---- 3. kernels vs plain at the flagship shapes ---------------------------
    cfg = flagship_model_config(tiny=False)
    gen = torch.Generator(device=device).manual_seed(SEED)
    hc = cfg.hash_ensemble.hash_encoding
    levels = HashGridLevels.create(hc.n_levels, hc.log2_hashmap_size,
                                   hc.base_resolution, hc.per_level_scale)
    width = cfg.hash_ensemble.n_hash_encodings * hc.n_features_per_level
    table = ((torch.rand(levels.total_entries, width, generator=gen,
                         device=device) - 0.5) * 2e-4).to(torch.bfloat16)
    quad = quad_kernel.quad_build_cuda(table, levels)
    plain = quad_kernel.quad_build_plain(table, levels)
    torch.cuda.synchronize()
    if not torch.equal(quad, plain):
        raise AssertionError("quad build kernel differs from its plain version")
    quad_err = float((quad.float() - plain.float()).abs().max())
    del quad, plain
    quad_ms = cuda_time_ms(lambda: quad_kernel.quad_build_cuda(table, levels))
    quad_plain_ms = cuda_time_ms(lambda: quad_kernel.quad_build_plain(table, levels))
    moved = table.numel() * table.element_size() * 5 / 1e9  # read 1x, write 4x
    log("kernels", f"B3 quad_build {tuple(table.shape)} -> "
                   f"({table.shape[0]}, {4 * width}) bf16: bit-exact; "
                   f"kernel {quad_ms:.3f} ms ({1e3 * moved / quad_ms:.0f} GB/s), "
                   f"plain {quad_plain_ms:.3f} ms")
    del table
    torch.cuda.empty_cache()

    dfc = cfg.deformation_field
    stem_in = 3 + 3 * 2 * dfc.n_freq_pos + dfc.warp_code_dim
    mlp_shapes = {  # name: (in, out, layers, width, skips, bias, out_act)
        "stem": (stem_in, dfc.mlp_layer_width, dfc.mlp_num_layers,
                 dfc.mlp_layer_width, tuple(dfc.skip_connections), True, "relu"),
        "base": (hc.n_levels * hc.n_features_per_level, 1 + cfg.geo_feat_dim,
                 cfg.num_layers, cfg.hidden_dim, (), False, None),
        "head": (3 + cfg.geo_feat_dim, 3, cfg.num_layers_color,
                 cfg.hidden_dim_color, (), False, "sigmoid"),
    }
    mlp_err, mlp_ms, mlp_plain_ms = 0.0, 0.0, 0.0
    for shape, (d_in, d_out, n_layers, w, skips, bias, act) in mlp_shapes.items():
        params = ParamTree(init_mlp(gen, d_in, d_out, n_layers, w, skips, bias))
        x = torch.randn(MLP_ROWS, d_in, generator=gen, device=device)
        out = fused_mlp.fused_mlp_cuda(params, x, act, skips)
        ref = fused_mlp.fused_mlp_plain(params, x, act, torch.bfloat16, skips)
        err = fused_mlp.compare_to_plain(out, ref)
        k_ms = cuda_time_ms(lambda: fused_mlp.fused_mlp_cuda(params, x, act, skips))
        p_ms = cuda_time_ms(lambda: fused_mlp.fused_mlp_plain(
            params, x, act, torch.bfloat16, skips))
        log("kernels", f"B1-fwd {shape} [{MLP_ROWS}, {d_in}] -> [{MLP_ROWS}, {d_out}]: "
                       f"max abs err {err['max_abs']:.3e} (tol {err['max_tol']:.3e}; "
                       f"{err['max_rel']:.3e} of max |plain|), "
                       f"mean abs err {err['mean_abs']:.3e} (tol {err['mean_tol']:.3e}); "
                       f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        mlp_err = max(mlp_err, err["max_abs"])
        mlp_ms += k_ms
        mlp_plain_ms += p_ms
    del params, x, out, ref
    torch.cuda.empty_cache()

    # ---- 4. render ------------------------------------------------------------
    model = NeRSembleModel(cfg, device)
    params = add_contrast(model.init_params(
        torch.Generator(device=device).manual_seed(SEED)))
    grid_occs = torch.from_numpy(
        synthetic_occupancy(cfg.grid_resolution, 0.05, SEED)).to(device)
    renderer = Renderer(model, params, grid_occs)
    frames = [pinhole_frame(FRAME_H, FRAME_W, ts) for ts in TIMESTEPS]
    step = cfg.window_hash_encodings_end  # end of schedule: windows 7 and 32
    log("render", f"flagship: table {tuple(params.field.table.shape)}, "
                  f"{levels.n_levels} levels, S={cfg.sampling.max_samples_per_ray}, "
                  f"candidates {model.config.sampling.max_candidates_per_ray}; "
                  f"step {step}: {sched_values(cfg, step)}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_mlp.LAUNCHES = 0
    quad_kernel.LAUNCHES = 0
    start = time.perf_counter()
    images = [renderer.render_image(frame, step, chunk=CHUNK) for frame in frames]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = {"fused_mlp_fwd": fused_mlp.LAUNCHES,
                "quad_build": quad_kernel.LAUNCHES}

    hits = [renderer.render_hit_mask(torch.from_numpy(f["origins"]).to(device),
                                     torch.from_numpy(f["directions"]).to(device))
            for f in frames]
    hit_fraction = float(sum(int(h.sum()) for h in hits)) / sum(h.numel() for h in hits)
    for ts, image in zip(TIMESTEPS, images):
        for key, val in image.items():
            if not np.isfinite(val).all():
                raise AssertionError(f"non-finite {key} in frame t={ts}")
        if image["rgb"].shape != (FRAME_H, FRAME_W, 3):
            raise AssertionError(f"rgb shape {image['rgb'].shape}")
        log("render", f"t={ts}: accumulation max {image['accumulation'].max():.4f} "
                      f"mean {image['accumulation'].mean():.4f}; depth max "
                      f"{image['depth'].max():.3f}; rgb mean {image['rgb'].mean():.4f}; "
                      f"|deformation| max {np.abs(image['deformation']).max():.3e}")
    if hit_fraction <= 0:
        raise AssertionError("no ray hits the occupied region")
    if not max(float(im["accumulation"].max()) for im in images) > 0:
        raise AssertionError("accumulation is zero everywhere")
    for i in range(len(TIMESTEPS)):
        for j in range(i):
            diff = float(np.abs(images[i]["rgb"] - images[j]["rgb"]).max())
            log("render", f"max |rgb(t={TIMESTEPS[i]}) - rgb(t={TIMESTEPS[j]})| {diff:.4f}")
            if not diff > 1 / 255:  # one 8-bit level
                raise AssertionError("frames of different timesteps are the same")
    for kernel, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the render path never launched {kernel}")
    log("render", f"3 frames {FRAME_W}x{FRAME_H}: {1e3 * elapsed / len(frames):.1f} "
                  f"ms/frame, hit fraction {hit_fraction:.4f}, "
                  f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
                  f"launches {launches}")

    # ---- 5. profile -------------------------------------------------------------
    profile_frame(renderer, frames[1], step)

    # ---- 6. reference: the GPU render vs the port's CPU path ------------------
    small = pinhole_frame(REF_H, REF_W, TIMESTEPS[1])
    start = time.perf_counter()
    gpu_image = renderer.render_image(small, step, chunk=REF_CHUNK)
    cpu_model = NeRSembleModel(cfg, "cpu")
    cpu_renderer = Renderer(cpu_model, copy.deepcopy(params).cpu(), grid_occs.cpu())
    cpu_image = cpu_renderer.render_image(small, step, chunk=REF_CHUNK)
    errs = {key: float(np.abs(gpu_image[key] - cpu_image[key]).max())
            for key in gpu_image}
    log("reference", f"{REF_W}x{REF_H} frame t={TIMESTEPS[1]}, GPU vs CPU max abs "
                     f"err {errs} (tol {REF_TOL}); accumulation max "
                     f"{cpu_image['accumulation'].max():.4f}; "
                     f"{time.perf_counter() - start:.1f} s")
    if not cpu_image["accumulation"].max() > 0.05:
        raise AssertionError("the reference frame is empty")
    for key in gpu_image:
        np.testing.assert_allclose(gpu_image[key], cpu_image[key], **REF_TOL,
                                   err_msg=key)

    print(json.dumps({"kernels": [
        {"name": "fused_mlp_fwd", "route": "cuda",
         "source": "nersemble_tpu_torch/csrc/fused_mlp_fwd.cu",
         "replaces": "nersemble_tpu/ops/fused_mlp.py:71",
         "launches": launches["fused_mlp_fwd"], "max_abs_err": mlp_err,
         "ms": mlp_ms, "plain_ms": mlp_plain_ms},
        {"name": "quad_build", "route": "cuda",
         "source": "nersemble_tpu_torch/csrc/quad_build.cu",
         "replaces": "nersemble_tpu/ops/quad_pallas.py:162",
         "launches": launches["quad_build"], "max_abs_err": quad_err,
         "ms": quad_ms, "plain_ms": quad_plain_ms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
