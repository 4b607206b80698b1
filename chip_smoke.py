#!/usr/bin/env python3
"""Run the PyTorch port's render, training and measurement paths once on
one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --parallel-only  # phases 1, 2 and 16; no result line

Phases, each printing its own lines:
  1. device    -- requires CUDA; prints the card and its power limit;
  2. build     -- compiles the CUDA kernels from csrc/ (one nvcc per source,
                  in parallel, sm_90a);
  3. kernels   -- each kernel vs its plain PyTorch version at the flagship
                  shapes, with times for both: the quad build (B3) on a
                  [6,537,216, 64] bf16 table (beside one index_select of
                  the table at a cached [4E] quad index, its library call,
                  held equal first) and the quad fold (B4) on a
                  [6,537,216, 256] bf16 gradient must be bit-exact; the fused
                  MLP forward (B1-fwd) on the stem, base and head at 98,304
                  rows within ops/fused_mlp.py's forward bound (max error
                  under half a bf16 ulp of the largest output, mean error
                  under 1e-5 of the mean output), each timed by its device
                  time under torch.profiler (CUDA events beside it) with its
                  TFLOP/s, GB/s and share of its bound, and, for information,
                  the stem as six unfused bf16 torch.matmul calls with bias,
                  relu and concat; the fused MLP backward (B2)
                  on the same shapes, on fused_mlp.positive_ weights and
                  inputs (no relu sign depends on rounding, no sum cancels),
                  within its bound (max error under 1e-3 of the largest
                  output, mean error under 1e-5 of the mean output, for dx,
                  every dW and db), each MLP printed with its TFLOP/s, its
                  bound for the bf16 split it runs and the bound of the
                  f32-product route; then B3 and B4 on narrow rows, the
                  single-grid field's [6,184,960, 2] bf16 table (4-byte rows)
                  and its [6,184,960, 8] gradient (4-byte quarters), at
                  the width one rank of four builds under the feature-sharded
                  table ([6,537,216, 16] bf16, 32-byte rows, and its [E, 64]
                  gradient), and on the single grid's column of one feature
                  that each of two ranks holds under that layout
                  ([6,184,960, 1]: 2-byte rows and quarters in bf16, 4-byte
                  ones in f32), bit-exact, timed beside their bound (B3 also
                  beside index_select, the narrow ones also by their device
                  time under torch.profiler; B4 on 2-byte quarters by its
                  whole-row loads and by 2-byte quarter loads), and B1-fwd
                  and B2 on
                  the colour head at the other configurations' input widths
                  31 (SH degree 4), 50 (appearance embedding) and 63 (both)
                  at 98,304 rows, within the same bounds, with the share of
                  their bound; then the blended encode's kernel pair
                  (A3-fwd, A3-bwd) against its plain version (ENCODE_CASES):
                  the flagship [6,537,216, 256] bf16 quad table at 73,728
                  and 98,304 samples, 16 tables ([6,537,216, 128]), the
                  single grid ([6,184,960, 8]), the flagship table in f32,
                  24 tables ([6,537,216, 192], a table count that is
                  not a power of two) and the single grid's column of one
                  feature ([6,184,960, 4] in bf16 and f32; A3-fwd also by
                  its device time), on positions half uniform, a quarter
                  in the grid's centre block and a quarter at the origin
                  (hot entries), with codes at the time embedding's
                  contrast scale: CG and BH bit for bit, the output and
                  the per-sample gradients within ops/hash_encoding.py
                  MAX_ERR_REL (2^-9 of max |plain|) and MEAN_ERR_REL (1e-5
                  of mean |plain|), every table-gradient entry within one
                  table-dtype ulp of the plain one plus the f32 error bound
                  of its rows summed in two orders
                  (hash_encoding.compare_table_grads; past one ulp only
                  where the rows cancel),
                  A3-bwd twice bit for bit; each timed beside its bound and
                  the plain version, A3-bwd also beside index_add_ of the
                  materialised f32 rows alone (every case) and by its parts
                  alone (sort, per-sample kernel, memset, chunk walk,
                  spanning runs; on the column the per-sample kernel, the
                  counting sort's passes and the reduce, and its kernels'
                  device times) beside the wrapper's wall time; then the
                  flagship digest case (scripts/encode_digests.py: seeded
                  inputs that owe nothing to PyTorch's generators) must give
                  the SHA-256 digests of out, CG, BH and the four gradients
                  that the kernels of commit 77061aa give (A3_DIGESTS), and
                  the column case (bf16 and f32) those of commit a38561d
                  (A3_COLUMN_DIGESTS);
 3b. copy kernels -- the measurement path's kernels vs their plain versions,
                  bit-exact, with the time of the one PyTorch call that
                  computes the same function: the row gather (P1) at the
                  gather probe's full size (2^20 rows of a [6,328,832, 128]
                  bf16 table, depth 32; index_select), and on the flagship
                  [6,537,216, 64] bf16 table the copy (P2; clone, then
                  P2 and clone timed in turns over three rounds), the
                  broadcast to four quarters (P3; repeat) and the
                  seven-fetch (P4; cat), P4 held first on seven distinct
                  inputs and timed, as the ladder runs it, on one input
                  passed seven times;
 3c. adam      -- the one-pass Adam kernel (csrc/fused_adam.cu) at the
                  flagship's leaves (the [6,537,216, 64] f32 table and the
                  rest, three groups' learning rates): three steps through
                  engine/optimizers.fused_adam_update on seeded gradients,
                  once by the plain update and once by the kernel (under
                  torch.cuda.set_sync_debug_mode("error"), one launch a
                  step), from the same start: SHA-256 of every parameter and
                  both moments must agree; then the kernel timed by CUDA
                  events and by its device time under torch.profiler,
                  beside its bound (28 bytes an element over 3.35 TB/s) and
                  the plain update's time;
  3d. time code -- the time codes' backward kernel (csrc/time_code_bwd.cu)
                  at the cells' shapes (TIME_CODE_CASES: a step's and a
                  field chunk's samples of nersemble.train and
                  nersemble_seq97.train, 16 timesteps, the 32-wide hash
                  code and the 128-wide deformation code, samples in rays
                  of one timestep): within the f32 sum's error bound of a
                  float64 index_add_, a second call bit for bit, timed by
                  CUDA events and by its two kernels' device time beside
                  its bound (the gradient read once, the indices, the rows
                  written) and beside index_put_(accumulate=True), the
                  indexing backward it replaced; then one flagship train
                  step at nersemble.train's budget (131,072 samples, two
                  field chunks) must launch it 4 times;
 4. render    -- the flagship model (random weights from a seed, with
                  contrast added so the hash table, the time codes and the
                  warp shape the frames) renders three 550x802 frames through
                  Renderer.render_image(chunk=8192) over bench.py's synthetic
                  grid (5% random fill + the centre block), camera at
                  distance 8, 60 degree vertical view; outputs must be
                  finite, rays must hit, the three timesteps must give three
                  different frames, and the forward kernels' launch counters
                  must grow during this phase; B1-fwd's launches by MLP are
                  printed as a histogram of rows per launch;
  5. profile   -- one more 550x802 frame under torch.profiler: device busy
                  share, the render path's ranges and the top kernels;
  6. train     -- the flagship training step as bench.py runs it (4096 rays
                  of its fixed random batch, S=256, budget 73,728, its grid,
                  sched at the end of the schedule, constant group learning
                  rates 5e-3 / 1e-3 / 5e-3, all six losses) through
                  NeRSembleTrainer.run_step: one warm-up step, 10 timed steps,
                  then one sampled occupancy update timed alone. Losses must
                  be finite and fall, the timed steps must make no
                  synchronizing call (torch.cuda.set_sync_debug_mode), and
                  all seven train-path kernels' launch counters (B1-fwd,
                  B2, B3, B4, A3-fwd, A3-bwd, Adam) must grow
                  during this phase; B1-fwd's rows-per-launch histograms of the timed
                  steps and of the occupancy update;
 6b. repeat    -- ROADMAP C11 at default settings (no deterministic
                  algorithms): the flagship's steps 79999-80001 of
                  flagship_steps_spec (as phase 16 runs them, a sampled
                  occupancy update at 80000) twice, and saved after 79999
                  and resumed in a fresh trainer: losses, parameters, both
                  Adam moments and the grid bit for bit (SHA-256);
  7. train profile -- one more step under torch.profiler: device busy
                  share, the step's ranges (march, field forward, encode
                  backward, Adam), the port's six kernels by name (the
                  kernels run through ctypes, which the profiler charges
                  to no range) and the top kernels;
  8. train reference -- a tiny-config training step on the GPU vs the
                  port's CPU path (contrast-scaled weights): losses and every
                  gradient leaf within tests/test_torch_kernels.py's bound;
  9. reference -- a 32x24 frame of the render scene on the GPU vs the port's
                  CPU path (the CPU path is held to the JAX package by
                  tests/test_torch_*.py);
 10. bench     -- nersemble_tpu_torch.bench in this process with --iters 5:
                  its JSON line must parse with bench.py's keys and a finite
                  loss, and the four train-path kernels must launch;
 11. diagnostics -- the measurement scripts, in this process:
                  bench_quad_build --diag (the P2 -> P3 -> P4 -> B3 ladder)
                  and its default mode (the alternative builds and folds
                  equal to the plain ones, B3/B4 bit-exact), gather_probe at
                  2^18 rows (P1 at every depth) and profile_step --iters 3;
                  P1-P4's launch counters must grow here;
 12. sequence  -- the sequence-training path: a synthetic 16-camera capture
                  with 3 timesteps written to a temporary directory at
                  550x802 (downscale 2 of 1100x1604; images, alpha maps,
                  16-bit depth maps, colour corrections, camera_params.json,
                  utils/synthetic_capture.py), then the port's train CLI
                  (scripts/train_nersemble.main) at the flagship defaults for
                  49 steps with the schedule windows compressed into the run
                  and eval batch / eval image / all eval images at steps 16 /
                  32 / 48, then resumed to step 53. Losses must be finite and
                  fall, the eval PSNR and SSIM finite (SSIM in [0, 1]), the
                  four train-path kernels' counters grow, metrics.jsonl hold
                  the JAX loop's keys at every step, the run hold exactly one
                  checkpoint and a config.yml that reads back equal, the
                  resumed run start at step 49 with the saved budget, and
                  steps 41-47 (no log, eval, save or device read) run under
                  torch.cuda.set_sync_debug_mode("error"). Prints the loop's
                  ms/step over those steps beside the train phase's, the
                  batch wait and copy seconds, the budget, each eval kind's
                  seconds, checkpoint save and load seconds and peak memory;
 13. serve     -- the serving CLIs on phase 12's run (step 52), each frame
                  they render timed and run under
                  torch.cuda.set_sync_debug_mode("warn"): a frame may wait
                  on the device only in engine/renderer.py's named reads
                  (the packed hit indices, the auto budget's probe and drop
                  counts, the frame's final copy) and in the per-grid-state
                  occupied-cell AABB. (a) the evaluate CLI, --max-eval-
                  timesteps 3 --n-rays-eval 8192 with the occupancy filter,
                  LPIPS on synthetic VGG-16-shaped weights and the vendored
                  JOD: 12 PNGs, finite PSNR and JOD, SSIM in [0, 1], and one
                  image's LPIPS on the card equal to the CPU's (rel
                  LPIPS_RTOL); when the filter kept no cell (no frame
                  hits), the CLI again on 4 views without it; (b) the
                  render CLI, --seconds 1 --fps 8
                  --downscale-factor 2 --n-rays 8192 with depth and
                  deformation: 8 frames of 550x802 per channel; (c) the view
                  CLI on a free local port, max_requests=3, a thread asking
                  for rgb, depth and deformation at width 256: each reply a
                  [H, 256, 3] PNG, the rgb frame hitting; (d) one eval view
                  with budget=None and "auto" on the run's warm-up grid
                  (printed: there None drops samples the probed budget
                  keeps) and on a 0.1% random grid (a carved scene's few
                  samples per ray), where the probed budget must stay
                  within the default and "auto" (probe, then cached) must
                  equal None within REF_TOL. A CLI whose frames hit
                  must launch B1-fwd and B3, and the phase must launch both
                  (the render CLI's orbit, the reference's head position,
                  may miss the synthetic sphere: its hit fraction is
                  printed, not held).
                  Prints seconds and launches per image / frame / request,
                  hit fractions, the filter's kept cells, JOD seconds, the
                  probed budget, ms for None vs auto and peak memory per CLI.
 14. variants  -- the model's other configurations, on phase 12's capture:
                  (a) the train CLI with --no-use-hash-ensemble --cone-angle
                  0.004 --early-stop-eps 1e-4 at its other defaults, 24 steps
                  with an eval image at 16 and one save; losses finite and
                  falling, all four train-path kernels launching and every
                  B3/B4 launch on narrow rows; then the evaluate CLI on 4
                  views without the filter and 2 frames of the render CLI
                  (each frame under set_sync_debug_mode("warn") as in phase
                  13); (b) NeRSembleTrainer.from_train_config with the
                  flagship model plus SH degree 4 and the appearance
                  embedding, 10 steps with an eval image at 8; B1-fwd must
                  launch on the colour head at d_in 63; then the appearance
                  gather's backward timed beside the time codes' at the
                  step's sample count. For (a) and (b): ms/step of quiet
                  steps (under set_sync_debug_mode("error")), seconds per
                  eval image, peak memory, launches. (c) every configuration
                  of tests/test_torch_variants.py (TINY_VARIANTS): the tiny
                  train step and a 32x24 frame on the GPU vs the port's CPU
                  path within TRAIN_REF_TOL and REF_TOL; the cone variant's
                  frame must take the two-phase prefilter.
 15. trained scene -- nersemble_tpu_torch/scripts/trained_scene.py's parts
                  on a fresh textured capture (the quality benchmark's,
                  16 cameras at 128x176, one timestep): (a) the quality
                  benchmark's static mode (single grid, no deformation)
                  for 6000 steps through the train CLI, evals of the 4
                  hold-out views at 2000, 4000 and 6000; the last eval PSNR
                  must beat the first and an image that is the background
                  colour everywhere on the same views, and B1-fwd, B2, B3
                  and B4 must launch; (b) the render benchmark on that run
                  at 802x550, 8 frames, chunk 16384, with the occupancy CC
                  filter: it must keep cells, its orbit must reach a mean
                  accumulation >= 0.01 and a hit fraction > 0; then
                  without it; B1-fwd and B3 must launch in both; then the
                  view CLI, 3 requests at width 256; (c) validate_poses on
                  the capture: the PNG decodes, its plotted centres are the
                  dataparser's and each is drawn at its pixel. Prints the
                  eval curve, ms/step, ms/frame, the probed auto budget,
                  the hit fraction, the filter's kept cells and its largest
                  thresholded component, the viewer's ms per request and
                  peak memory per part.
 16. parallel  -- the multi-device layouts (nersemble_tpu_torch/parallel/)
                  on the flagship step with contrast-scaled weights: 4096
                  rays of parallel/compare.synthetic_batches, S=256, budget
                  73,728, bench.py's grid, steps 79999-80001 through
                  run_step (a sampled occupancy update and a budget
                  decision at 80000), PyTorch's deterministic algorithms
                  off. (a) one NCCL rank (a spawned
                  process) against the plain trainer in this process:
                  losses, parameters and first moments bit for bit
                  (SHA-256); (b) at an f32 table, ZeRO-3 and the replicated
                  table over two gloo ranks sharing this card (NCCL takes
                  one card per rank), and one rank: on each run the ranks'
                  replicated parameters and grids bit for bit; ZeRO-3
                  against the replicated table after the three steps
                  within atol 5e-5 rtol 1e-3 (tests/test_table_sharding.py
                  :170); against one rank, the first step's gradients (the
                  first moments) within tests/test_torch_train_step.py's
                  bounds (f32; bf16 for the warp head's weight, whose
                  gradient passes a bf16 cast on each rank); ms/step,
                  collectives' host ms per step and peak GiB per rank;
                  B1-B4 must launch in (a)'s rank and (b)'s ZeRO-3 rank 0.
                  (c) with two or more cards visible: ZeRO-3 over NCCL on
                  all of them, its first step's gradients against one rank
                  as in (b), then bench_projection; with one card, a line
                  says (c) was not run. (d) the single-grid field at the
                  train CLI's defaults ([6,184,960, 2] bf16 table) in the
                  feature-sharded layout over two gloo ranks on this card,
                  one column each (B3 on 2-byte rows, B4 on 2-byte
                  quarters, A3 on quad rows of 4 elements: their narrow
                  launch counts must be > 0), and one rank: the first
                  step's gradients within the same bounds (the table's at
                  the bf16 bound), whether the three steps end bit for bit
                  (printed), and two runs of two ranks bit for bit
                  (SHA-256). (e) on a 128x176 synthetic capture, the train
                  CLI with --vis viewer (single grid, learning rate 0, two
                  steps, a request queued during step 0;
                  parallel/compare.viewer_run) over two gloo ranks and on
                  one rank: each reply a PNG, the frames within atol 5e-5
                  rtol 1e-4 (tests/test_torch_parallel_io.py's render
                  bound), B1-fwd, B3 and A3-fwd launched; then the
                  evaluate CLI on the two-rank run (its config says
                  data_axis_size 2: two gloo ranks) and on a copy that says
                  1: PNGs within one 8-bit level, metrics within rtol 1e-4.
                  (f) the flagship's levels and entries with 6 logical
                  tables of 2 features ([6,537,216, 12] table, f32 as in
                  (b)) in the feature-sharded layout over four gloo ranks
                  on this card, 3 columns each (tables 1 and 4 cut between
                  two ranks; each pads its window to 4 columns,
                  models/field.tp_window), and one rank: the first step's
                  gradients within (b)'s bounds; B3, B4, A3-fwd and A3-bwd
                  launched on every rank.
Then one JSON line with the eleven kernels (launches on the training path
for B1-B4, A3 and Adam and on the measurement path for P1-P4, times, the bound
and the library call's time; A3 with every case of phase 3; B3/B4 also
with their narrow-row, sharded-row and one-feature column times and bounds
(B3 beside its library call, index_select at a cached quad index), B1-fwd
and B2 with the variant heads', and B1-B4 with their launches in phase
14's runs (a) and (b), phase 15's quality run and render bench and phase
16's ranks), and the last line
{"ok": true, "device": {...}}. Any failure raises: the exit code is non-zero
and the last line is not printed. Without a CUDA device nothing runs.
"""

import collections
import contextlib
import copy
import hashlib
import io
import json
import math
import time
import warnings

import numpy as np

SEED = 0
FRAME_H, FRAME_W = 802, 550      # the reference's 3208x2200 at downscale 4
CHUNK = 8192                     # the render CLI's default --n-rays 2^13
TIMESTEPS = (0, 3, 7)
MLP_ROWS = 98304                 # the flagship sample-chunk cap
QUAD_SMALL_ITERS = 50            # timed calls of B3/B4 on the narrow and sharded rows
REF_H, REF_W, REF_CHUNK = 32, 24, 256
# GPU vs CPU render of the reference frame: the same plain code but for the
# two kernels (B3 bit-exact, B1-fwd summing in another order) differs by
# ~7e-6 on an H100. Swapping two quarters of the quad table moves the tiny
# config's frame by 2.6e-3 to 5e-3, so a wrong quad or encode fails this.
REF_TOL = dict(rtol=0.0, atol=1e-4)
PROFILE_RANGES = ("render:march", "render:sigma_probe", "render:field",
                  "encode:quad_build", "encode:fwd")
OWN_KERNELS = ("fused_mlp_fwd_kernel", "fused_mlp_bwd_kernel", "pack_stream_kernel",
               "partial_sum_kernel", "quad_build_tma_kernel", "quad_build_rows_kernel",
               "quad_fold_kernel", "quad_build_narrow_kernel", "quad_fold_narrow_kernel",
               "quad_build_half_kernel", "quad_fold_half_kernel",
               "be_fwd_kernel", "be_fwd_narrow_kernel", "be_sample_kernel",
               "be_chunk_kernel", "be_span_kernel", "be_col_count_kernel",
               "be_col_colscan_kernel", "be_col_scatter_kernel", "be_col_starts_kernel",
               "be_col_reduce_kernel", "fused_adam_kernel", "tc_rows_kernel",
               "tc_sum_kernel")
# A3-bwd's kernels on quad rows of 4 elements (one feature)
COLUMN_BWD_KERNELS = ("be_sample_kernel", "be_col_count_kernel", "be_col_colscan_kernel",
                      "be_col_scatter_kernel", "be_col_starts_kernel", "be_col_reduce_kernel")
# A3 against its plain version: (case, quad table width, dtype, samples,
# single grid); the first is the flagship table at the bench's budget; 24
# tables (--n-hash-encodings 24): a table count that is not a power of two
ENCODE_CASES = [("flagship", 256, "bfloat16", 73728, False),
                ("flagship", 256, "bfloat16", 98304, False),
                ("16 tables", 128, "bfloat16", 73728, False),
                ("single grid", 8, "bfloat16", 73728, True),
                ("flagship f32", 256, "float32", 73728, False),
                ("24 tables", 192, "bfloat16", 73728, False),
                ("single grid column", 4, "bfloat16", 73728, True),
                ("single grid column f32", 4, "float32", 73728, True)]
ENCODE_CODE_STD = 0.01 / math.sqrt(32)  # the time embedding's init (models/nersemble.py)
# SHA-256 of the flagship digest case's outputs (scripts/encode_digests.py)
# from the blended-encode kernels of commit 77061aa, on an NVIDIA H100 80GB
# HBM3 at 700 W: the redesigned kernels must give the same bits
A3_DIGESTS = {
    "out": "fa82770a474854353f627f54c0481ccb7912bfaf7bebddf3bf908995c6dd2563",
    "CG": "443dbc4daa700bacae4690cb3213dc2276875e34b88131e05eb10f9b8bad5468",
    "BH": "a01df2c21ec816b72a442c5ecedd7b02471ac0b8fa550f59333a7a12868d2920",
    "d_table": "b9629aadf60d109addd1961cdde9910f04c5d4b52d2ddf19468eaa5d7bf3283e",
    "d_code": "e830595451b26c0efd27fcf60643706cfb78b20364c67c00bc393b59d4e720f9",
    "d_wy": "bdb15ac14bdb6736a78952ce98404ccbeba4b7aed015dc57fac9358a6af9c63f",
    "d_fx": "8a5f5b5ce27b663546258e22f1999e4160cc8d1c829874e508e5ae9395f93bfe",
    "d_fz": "0a97eb717e39c5f7f03a917e0131c58ad1d840c4a6111632c567c4a3689531c0"}
# SHA-256 of the column digest case's outputs per dtype (scripts/encode_digests.py
# --cases column: the single grid's one-feature column, [6,184,960, 4], at
# 73,728 samples) from the blended-encode kernels of commit a38561d (its
# sort-based backward), on an NVIDIA H100 80GB HBM3 at 700 W: the bucketed
# backward and the forward with more loads in flight must give the same bits
A3_COLUMN_DIGESTS = {
    "bfloat16": {
        "out": "b4ec529e6662b6b501d5279920ed22a9497d4ea75ccf8d645c048c1fed8b2406",
        "CG": "e1e3cec53bcd25d219065b654735aaa9514aee62d6fbbcd7bd431ac758bd419e",
        "d_table": "6cf924a832f1af8cba72e8a81f7ac45ac0c7888aa83c0530aa7b00c19bd8e85c",
        "d_wy": "edc2c70ae0acffb9ab82cf651493868e19ed94f091153b357969880d83c8c768",
        "d_fx": "ca1a27cec6e8f850273746e1c05c02da090c0dacda9f312724a771e882cd4db8",
        "d_fz": "1402d743e5bc885852c00ff335f1bd1fe78ad70edbddf4fff1e479ca5ef61ea2"},
    "float32": {
        "out": "99322b8a7cc1c108a121462835ad6b8027a60857be91b5e0bc723d5f7e7d8ac8",
        "CG": "a18ff991f63b3184962f42ee63a5d641c2cd518e999c9d7b785c99f0f2c6441e",
        "d_table": "764122b455b6d339b708b01c5a39f0a92160a0efcb1b016f5c7343d7ce65fed8",
        "d_wy": "e3eb9c2d306804e5034a99620dc87438a3bb289af075254366362e688b443f66",
        "d_fx": "424324abf385e0d138bfcbf4397d9224dd943ad2e8d59c44070fe329b84417b9",
        "d_fz": "4167c51f80cbe93d378a647741b76f5950f6dec910dc8b1b9fea5a4e95049344"}}
TRAIN_RAYS, TRAIN_STEPS = 4096, 10
BENCH_ITERS = 5
BENCH_KEYS = {"metric", "value", "unit", "extra"}
BENCH_EXTRA_KEYS = {"ray_samples_per_sec", "step_ms", "n_rays", "budget",
                    "n_candidates", "device", "loss", "power_limit"}
TRAIN_RANGES = ("loop:step", "loop:occupancy", "loop:budget", "train:forward",
                "render:march", "render:field", "encode:quad_build", "encode:fwd",
                "train:backward", "bwd:hash_encode", "bwd:fused_mlp", "bwd:quad_fold",
                "train:adam")
# GPU vs CPU train step (tiny config, contrast-scaled bf16): the same plain
# code but for the six kernels. B3/B4 are bit-exact; B1-fwd/B2 and A3 sum
# in other orders, so a recomputed bf16
# activation can round to its neighbour. Losses to rtol 1e-3; every gradient
# leaf to rtol 1e-2 with an atol of 2e-3 of the leaf's max, the table's to
# 2^-6 of its max (an entry rounded to the neighbouring bf16 value).
TRAIN_REF_TOL = {"loss_rtol": 1e-3, "rtol": 1e-2, "atol": 2e-3,
                 "table_atol": 2.0 ** -6}
COPY_ROUNDS = 3  # P2 and clone() timed in turns
# Adam at the flagship's leaves (phase 3c, tests/test_torch_kernels.py):
# three groups' learning rates, three steps
ADAM_LRS = {"fields": 5e-3, "deformation_field": 1e-3, "embeddings": 4e-3}
ADAM_STEPS = 3
# the time codes' backward (phase 3d, tests/test_torch_kernels.py): (case,
# samples, samples a ray) at 16 timesteps and the two codes' widths; a
# field chunk holds at most 98,304 samples
TIME_CODE_T, TIME_CODE_WIDTHS = 16, (32, 128)
TIME_CODE_CASES = [("nersemble.train step", 131072, 32),
                   ("nersemble.train chunk", 65536, 32),
                   ("nersemble_seq97.train step", 372000, 91),
                   ("nersemble_seq97.train chunk", 93184, 91)]
TIME_CODE_KERNELS = ("tc_rows_kernel", "tc_sum_kernel")
TIME_CODE_BUDGET = 131072  # nersemble.train's: 0.125 of 4096 rays x 256 slots
# the sequence phase: the train CLI at its flagship defaults on a synthetic
# capture, 49 steps with the schedule windows inside the run, resumed to 53
SEQ_NAME, SEQ_PARTICIPANT, SEQ_SEQUENCE = "seq", 30, "SYN-SEQ"
SEQ_STEPS, SEQ_RESUMED_STEPS = 49, 53
SEQ_ORIGINAL_SIZE = (1100, 1604)  # stored at downscale 2: 550x802
SEQ_CADENCE = {"log": 10, "eval_batch": 16, "eval_image": 32, "eval_all": 48}
SEQ_ARGS = [str(SEQ_PARTICIPANT), SEQ_SEQUENCE,
            "--window-deform-end", "24", "--window-hash-encodings-begin", "8",
            "--window-hash-encodings-end", "40",
            "--steps-per-eval-batch", str(SEQ_CADENCE["eval_batch"]),
            "--steps-per-eval-image", str(SEQ_CADENCE["eval_image"]),
            "--steps-per-eval-all-images", str(SEQ_CADENCE["eval_all"]),
            "--steps-per-save", "1000"]
SEQ_QUIET = (41, 47)  # steps off every cadence: log, evals, save, budget, grid
SEQ_EVALS = ("_eval_batch", "_eval_image", "_train_image", "_eval_all_images",
             "save_run_checkpoint")
# the keys the JAX trainer's loop writes (nersemble_tpu/engine/trainer.py
# :562-602, 620-927), by cadence
SEQ_LOG_KEYS = {"train_loss", "train_psnr", "rays_per_sec", "samples_per_batch",
                "dropped_samples_per_batch", "budget_dropped_per_batch",
                "loss/rgb_loss", "loss/alpha_loss", "loss/empty_loss",
                "loss/near_loss", "loss/depth_loss", "loss/dist_loss",
                "lr/fields", "lr/deformation_field", "lr/embeddings",
                "window_param/window_deform", "window_param/window_hash",
                "window_param/eps_depth", "memory/gib_in_use",
                "memory/peak_gib_in_use", "memory/gib_limit"}
SEQ_PARAM_KEYS = {"params/field", "params/deformation", "params/time_embedding",
                  "params/time_embedding_deformation", "params/total"}
SEQ_EVAL_IMAGE_KEYS = {f"eval_image_{k}{m}" for k in ("psnr", "ssim", "mse")
                       for m in ("", "_masked")} | {"train_image_psnr"}
SEQ_EVAL_ALL_KEYS = ({"eval_all_psnr", "eval_all_ssim", "eval_all_psnr_masked",
                      "eval_all_ssim_masked", "eval_all_mse_masked"}
                     | {f"eval_cam{c}_psnr" for c in (3, 6, 11, 15)}
                     | {f"eval_t{t}_psnr" for t in range(3)})
# the serve phase: the serving CLIs on the sequence phase's run
SERVE_EVAL_ARGS = ["--max-eval-timesteps", "3", "--n-rays-eval", str(CHUNK)]
SERVE_RENDER_ARGS = ["--seconds", "1", "--fps", "8", "--downscale-factor", "2",
                     "--n-rays", str(CHUNK), "--render-depth", "--render-deformations"]
SERVE_VIEW_WIDTH = 256
SERVE_CHANNELS = ("rgb", "depth", "deformation")
# LPIPS of one 550x802 image on the card vs the CPU, both float32 with
# cuDNN's TF32 off: 13 convolutions summed in other orders
LPIPS_RTOL = 1e-4
# where a served frame may wait on the device: the renderer's named reads
# and the occupied-cell AABB (once per grid state)
SERVE_SYNC_FILES = {"renderer.py", "sampling.py"}
# (d)'s sparse grid: the eval march dilates it 27-fold, and a ray still
# crosses only ~3 occupied cells, ~10 samples (a carved scene's count), so
# the default budget (32 samples per ray) drops none
SERVE_SPARSE_FILL = 0.001
# the colour head's input width under the other configurations: direction
# encoding (3, or 16 at SH degree 4) + 15 geo features (+ 32 appearance)
VARIANT_HEAD_WIDTHS = {"SH 4": 31, "appearance": 50, "SH 4 + appearance": 63}
# the variants phase on the sequence phase's capture: (a) the train CLI with
# the single-grid field, nerfstudio's Instant-NGP cone angle and early stop,
# at its other defaults; (b) the flagship with SH degree 4 and the
# appearance embedding through NeRSembleTrainer.from_train_config
VAR_A_NAME, VAR_A_STEPS, VAR_A_QUIET = "single", 24, (11, 15)
VAR_A_FLAGS = ["--no-use-hash-ensemble", "--cone-angle", "0.004",
               "--early-stop-eps", "1e-4", "--steps-per-eval-batch", "0",
               "--steps-per-eval-image", "16", "--steps-per-eval-all-images", "0",
               "--steps-per-save", "1000"]
VAR_B_NAME, VAR_B_STEPS, VAR_B_QUIET = "shapp", 10, (2, 7)
VAR_B_FLAGS = ["--steps-per-eval-batch", "0", "--steps-per-eval-image", "8",
               "--steps-per-eval-all-images", "0", "--steps-per-save", "1000"]
VAR_EVALS = ("_eval_image", "_train_image", "save_run_checkpoint")
# the trained-scene phase (scripts/trained_scene.py's parts): the quality
# benchmark's static mode on a fresh textured capture, long enough that the
# CC filter keeps a component (H100: at 800-3000 steps no cell reaches its
# threshold, or a component of tens of cells does and its erosion blur
# erases it; 63k-77k cells kept at 6000 steps, 18.3-18.6 dB), then the
# render benchmark on its run at 802x550 with and without the CC filter and
# the viewer at width 256, then the capture's pose figure
TRAINED_ARGS = ["--mode", "static", "--steps", "6000", "--eval-every", "2000",
                "--view-requests", "3"]
# the parallel phase: the flagship step through parallel/ (bench.py's grid,
# 4096 rays of parallel/compare.synthetic_batches, S=256, the steady-state
# budget 73,728, the schedule's end, constant learning rates, weights scaled
# by utils/cameras.add_contrast) for steps 79999-80001: the last takes the
# budget decided at 80000, after a sampled occupancy update there
# (flagship_steps_spec; the encode's backward sums in one fixed order, so no
# run needs PyTorch's deterministic algorithms). (a) one NCCL rank against the plain
# trainer, bit for bit; (b) at an f32 table, ZeRO-3 over two gloo ranks
# sharing the card against the replicated table on two ranks (the layout
# alone differs): every parameter after the three steps at the JAX
# package's multi-device bound (tests/test_table_sharding.py:170); and
# against one rank, the first step's gradients (0.1 g: the first Adam
# moments) at tests/test_torch_train_step.py's f32 gradient bound. Not the
# parameters after three steps: on the card a gradient that differs by its
# sums' order (1e-7 to 1e-5 of its leaf's largest) flips Adam's step of the
# entries that cancel, the occupancy update at 80000 turns the moved
# densities into other cells and samples, and by step 80001 about 40% of
# the table's entries on an H100 80GB HBM3 are past the JAX bound while the
# first step's gradients hold theirs; the phase prints that count.
PAR_FIRST_STEP, PAR_STEPS = 79999, 3
PAR_TOL = {"atol": 5e-5, "rtol": 1e-3}
# the gradient bound, atol as a fraction of the leaf's largest: f32, and
# bf16 for the weights whose gradient passes a bf16 cast (ops/mlp.py
# apply_linear's round_to: each rank rounds its share before the sum)
PAR_GRAD_TOL = {"float32": (1e-3, 1e-4), "bfloat16": (1e-2, 2e-3)}
PAR_BF16_GRADS = ("deformation.head_rv.w",)
# (e): the viewer and the evaluate CLI over two gloo ranks on this card on a
# small capture (the single-grid model at the train CLI's defaults, at
# learning rate 0: both runs hold the same parameters), held to one rank at
# tests/test_torch_parallel_io.py's render bound; PNGs within one 8-bit level
SERVE_RANKS_SIZE = (128, 176)
SERVE_RANKS_TOL = {"atol": 5e-5, "rtol": 1e-4}
SERVE_RANKS_TRAIN = ["30", "SYN-1", "--device", "cuda", "--vis", "viewer",
                     "--no-use-hash-ensemble",
                     "--viewer-port", "0", "--max-num-iterations", "2",
                     "--lr-main", "0", "--lr-deformation-field", "0",
                     "--lr-embeddings", "0", "--steps-per-eval-batch", "0",
                     "--steps-per-eval-image", "0", "--steps-per-eval-all-images", "0",
                     "--steps-per-save", "1000", "--dist-backend", "gloo"]
SERVE_RANKS_EVAL = ["--max-eval-timesteps", "2", "--n-rays-eval", str(CHUNK),
                    "--no-use-occupancy-grid-filtering"]
# the train path's hand kernels (ops/launch_counts.py)
TRAIN_KERNELS = ("fused_mlp_fwd", "fused_mlp_bwd", "quad_build", "quad_fold",
                 "blended_encode_fwd", "blended_encode_bwd")
# a served frame's launches by kernel (RenderLog)
FRAME_KEYS = {"fused_mlp_fwd": "fwd", "quad_build": "build", "blended_encode_fwd": "encode"}


def _single_grid(cfg):
    cfg.use_hash_ensemble, cfg.hash_ensemble = False, None
    cfg.num_levels, cfg.log2_hashmap_size = 4, 10
    cfg.base_resolution, cfg.max_res = 4, 32


def _static(cfg):
    cfg.use_deformation_field, cfg.deformation_field = False, None


def _cone(cfg):
    cfg.cone_angle, cfg.grid_levels = 0.004, 2
    cfg.sampling.eval_fine_candidates = 256  # below the auto 512: two-phase


def _early_stop(cfg):
    cfg.early_stop_eps = 1e-4


def _sh_appearance(cfg):
    cfg.spherical_harmonics_degree = 4
    cfg.use_appearance_embedding, cfg.num_images = True, 5


# the other configurations as edits of the tiny flagship config (of either
# package: tests/test_torch_variants.py holds the port to JAX on them)
TINY_VARIANTS = {
    "single_grid": (_single_grid,),
    "single_grid_static": (_single_grid, _static),
    "ensemble_static": (_static,),
    "cone": (_cone,),
    "early_stop": (_early_stop,),
    "sh_appearance": (_sh_appearance,),
}


T0 = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """One line of a phase, with the seconds since the script started."""
    print(f"[{phase} +{time.perf_counter() - T0:.0f}s] {msg}", flush=True)


def kernel_entry(err: float, ms: float, plain_ms: float, bound, library_ms=None) -> dict:
    """A kernel's line of the summary; ``bound`` is (bound_ms, bound_by)."""
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}


def profile_run(phase: str, fn, ranges, unit: str) -> None:
    """``fn()`` under torch.profiler: wall time, summed kernel time (one
    stream, so kernels do not overlap) and the busy share, then the given
    ranges and the top kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    events = prof.key_averages()
    # record_function ranges also show as GPU annotations: keep kernels only
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and e.key not in ranges),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        log(phase, f"wall {wall_ms:.1f} ms/{unit}; the profiler traced no kernels")
        return
    log(phase, f"wall {wall_ms:.1f} ms/{unit}; kernels {busy_ms:.1f} ms/{unit}; "
               f"device busy {100 * busy_ms / wall_ms:.1f}%, idle "
               f"{100 * (1 - busy_ms / wall_ms):.1f}%")
    for e in events:
        if e.key in ranges and e.device_type == DeviceType.CPU:
            log(phase, f"range {e.key:20s} calls {e.count:4d}  host "
                       f"{e.cpu_time_total / 1e3:8.1f} ms  kernels "
                       f"{e.device_time_total / 1e3:8.1f} ms "
                       f"({100 * e.device_time_total / 1e3 / busy_ms:5.1f}%)")
    # the port's own kernels, launched through ctypes, belong to no range
    for name in OWN_KERNELS:
        own = [e for e in kernels
               if e.key.removeprefix("void ").startswith((name + "(", name + "<"))]
        if own:
            ms = sum(e.self_device_time_total for e in own) / 1e3
            log(phase, f"kernel {name:20s} calls {sum(e.count for e in own):4d}  "
                       f"{ms:8.2f} ms ({100 * ms / busy_ms:5.1f}%)")
    for e in kernels[:12]:
        log(phase, f"{e.self_device_time_total / 1e3:8.2f} ms "
                   f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
                   f"x{e.count:<5d} {e.key[:100]}")


def mlp_shapes(cfg):
    """name: (in, out, layers, width, skips, bias, out_act) of the three
    flagship MLPs."""
    hc = cfg.hash_ensemble.hash_encoding
    dfc = cfg.deformation_field
    stem_in = 3 + 3 * 2 * dfc.n_freq_pos + dfc.warp_code_dim
    return {
        "stem": (stem_in, dfc.mlp_layer_width, dfc.mlp_num_layers,
                 dfc.mlp_layer_width, tuple(dfc.skip_connections), True, "relu"),
        "base": (hc.n_levels * hc.n_features_per_level, 1 + cfg.geo_feat_dim,
                 cfg.num_layers, cfg.hidden_dim, (), False, None),
        "head": (3 + cfg.geo_feat_dim, 3, cfg.num_layers_color,
                 cfg.hidden_dim_color, (), False, "sigmoid"),
    }


def single_grid_levels():
    """The table layout of the single-grid field at the train CLI's
    defaults (16 levels, 2^19 rows, resolution 16 to 2048)."""
    from nersemble_tpu_torch.models.field import build_levels
    from nersemble_tpu_torch.scripts import train_nersemble

    args = train_nersemble.build_parser().parse_args(
        SEQ_ARGS[:2] + ["--no-use-hash-ensemble"])
    return build_levels(train_nersemble.build_config(args, "levels", ".").model)


def kernel_device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Mean device time per launch of ``kernel`` over ``iters`` calls of
    ``fn`` under torch.profiler: the kernel's own time. CUDA events around
    the calls time the host instead wherever one call's Python (~25 us for
    the fused MLP's wrapper) outlasts its kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the mean over the launches the profiler recorded: a series of
    # back-to-back profiles can lose kernel records (19 of 20 seen once on
    # an H100, none of 20 in another run), so a short count profiles again,
    # up to three times; more than were launched would mean a wrong
    # attribution
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        own = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.key.removeprefix("void ").startswith((kernel + "(", kernel + "<"))]
        seen = sum(e.count for e in own)
        if seen > iters:
            break
        if iters // 2 <= seen:
            return sum(e.self_device_time_total for e in own) / seen / 1e3
        log("kernels", f"the profiler saw {seen} of {iters} launches of {kernel}; "
                       f"profiling again")
    raise AssertionError(f"the profiler saw {[e.count for e in own]} launches of "
                         f"{kernel}, not {iters}")


def kernels_device_ms(fn, kernels, iters: int = 20) -> dict:
    """Mean device time per call of ``fn`` of each named kernel (all its
    launches in a call, summed) under torch.profiler, and their sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for kernel in kernels:
        own = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.key.removeprefix("void ").startswith((kernel + "(", kernel + "<"))]
        out[kernel] = sum(e.self_device_time_total for e in own) / iters / 1e3
    out["sum"] = sum(out.values())
    return out


def unfused_chain(params, x, out_activation, skips):
    """The MLP as separate bf16 PyTorch calls (x cast, then per layer
    matmul, bias, relu, the skip's concat): a yardstick for the fusion,
    used nowhere in the port."""
    import torch
    x_in = x.to(torch.bfloat16)
    h = x_in
    layers = params.layers
    for i, layer in enumerate(layers):
        if i in skips and i > 0:
            h = torch.cat([h, x_in], dim=-1)
        h = torch.matmul(h, layer.w.to(torch.bfloat16))
        if "b" in layer:
            h = h + layer.b.to(torch.bfloat16)
        if i < len(layers) - 1 or out_activation == "relu":
            h = torch.relu(h)
    return h


def rows_histogram(phase: str, cfg, counts) -> None:
    """Print B1-fwd's launches on a path by MLP, bucketed by rows per launch
    (``fused_mlp.ROWS``: (d_in, d_out, rows) -> launches)."""
    edges = (64, 1024, 16384, 65536, math.inf)
    for name, (d_in, d_out, *_) in mlp_shapes(cfg).items():
        mine = {rows: n for (a, b, rows), n in counts.items() if (a, b) == (d_in, d_out)}
        buckets, lo = [], 1
        for hi in edges:
            n = sum(c for rows, c in mine.items() if lo <= rows <= hi)
            label = f">={lo}" if hi == math.inf else f"{lo}-{hi}"
            buckets.append(f"{label}: {n}")
            lo = hi + 1
        log(phase, f"B1-fwd {name}: {sum(mine.values())} launches, "
                   f"{sum(r * n for r, n in mine.items())} rows; rows per launch "
                   + ", ".join(buckets))


def quad_index(levels, device):
    """[4E] int64 rows of the table whose ``index_select``, viewed [E, 4W],
    is the quad table: entry e's own row, then its rows rolled by each
    level's z, x and x+z strides. Built once per level layout."""
    import torch
    from nersemble_tpu_torch.ops import quad_kernel
    quarters = [torch.arange(levels.total_entries)]
    for strides in quad_kernel.quarter_strides(levels):
        quarters.append(torch.cat([
            off + (torch.arange(size) + stride % size) % size
            for off, size, stride in zip(levels.offsets, levels.sizes, strides)]))
    return torch.stack(quarters, dim=1).reshape(-1).to(device)


def quad_library_ms(table, levels, what: str) -> float:
    """B3's library yardstick: one ``torch.index_select`` of the table at
    the cached quad index, viewed [E, 4W]; held equal to the plain build,
    then timed (the index is built outside the timing). Used nowhere in the
    port."""
    import torch
    from nersemble_tpu_torch.ops import quad_kernel
    from nersemble_tpu_torch.utils.timing import cuda_time_ms

    index = quad_index(levels, table.device)
    entries, width = table.shape

    def library():
        return torch.index_select(table, 0, index).view(entries, 4 * width)

    if not torch.equal(library(), quad_kernel.quad_build_plain(table, levels)):
        raise AssertionError(f"index_select at the quad index ({what}) differs "
                             f"from the plain quad build")
    ms = cuda_time_ms(library)
    del index
    return ms


def kernel_phase(cfg, levels, device):
    """Every kernel of the train and render paths vs its plain version at
    the flagship shapes; returns {kernel: kernel_entry(...)}. One PyTorch
    call computes B3's function, ``index_select`` at a cached index
    (``quad_library_ms``); none computes B4's (a fold that sums the four
    rolled quarters in f32 and casts back), B1-fwd's or B2's: their
    library_ms is None."""
    import torch
    from nersemble_tpu_torch.ops import fused_mlp, quad_kernel
    from nersemble_tpu_torch.ops.mlp import init_mlp
    from nersemble_tpu_torch.utils.params import ParamTree
    from nersemble_tpu_torch.utils.timing import bound_ms, cuda_time_ms

    gen = torch.Generator(device=device).manual_seed(SEED)
    n_parts = torch.cuda.get_device_properties(device).multi_processor_count
    hc = cfg.hash_ensemble.hash_encoding
    width = cfg.hash_ensemble.n_hash_encodings * hc.n_features_per_level
    results = {}

    table = ((torch.rand(levels.total_entries, width, generator=gen,
                         device=device) - 0.5) * 2e-4).to(torch.bfloat16)
    quad = quad_kernel.quad_build_cuda(table, levels)
    plain = quad_kernel.quad_build_plain(table, levels)
    torch.cuda.synchronize()
    if not torch.equal(quad, plain):
        raise AssertionError("quad build kernel differs from its plain version")
    err = float((quad.float() - plain.float()).abs().max())
    del quad, plain
    k_ms = cuda_time_ms(lambda: quad_kernel.quad_build_cuda(table, levels))
    p_ms = cuda_time_ms(lambda: quad_kernel.quad_build_plain(table, levels))
    l_ms = quad_library_ms(table, levels, "wide rows")
    moved = table.numel() * table.element_size() * 5  # read 1x, write 4x
    results["quad_build"] = kernel_entry(err, k_ms, p_ms, bound_ms(moved), l_ms)
    log("kernels", f"B3 quad_build {tuple(table.shape)} -> "
                   f"({table.shape[0]}, {4 * width}) bf16: bit-exact; "
                   f"kernel {k_ms:.3f} ms ({moved / k_ms / 1e6:.0f} GB/s, bound "
                   f"{results['quad_build']['bound_ms']:.3f} ms), plain {p_ms:.3f} ms, "
                   f"index_select {l_ms:.3f} ms")
    del table
    torch.cuda.empty_cache()

    grad = ((torch.rand(levels.total_entries, 4 * width, generator=gen,
                        device=device) - 0.5) * 2e-3).to(torch.bfloat16)
    folded = quad_kernel.quad_fold_cuda(grad, levels)
    plain = quad_kernel.quad_fold_plain(grad, levels)
    torch.cuda.synchronize()
    if not torch.equal(folded, plain):
        raise AssertionError("quad fold kernel differs from its plain version")
    err = float((folded.float() - plain.float()).abs().max())
    del folded, plain
    k_ms = cuda_time_ms(lambda: quad_kernel.quad_fold_cuda(grad, levels))
    p_ms = cuda_time_ms(lambda: quad_kernel.quad_fold_plain(grad, levels))
    moved = grad.numel() * grad.element_size() * 1.25  # read 4W, write W
    results["quad_fold"] = kernel_entry(err, k_ms, p_ms, bound_ms(moved))
    log("kernels", f"B4 quad_fold {tuple(grad.shape)} -> "
                   f"({grad.shape[0]}, {width}) bf16: bit-exact; "
                   f"kernel {k_ms:.3f} ms ({moved / k_ms / 1e6:.0f} GB/s, bound "
                   f"{results['quad_fold']['bound_ms']:.3f} ms), plain {p_ms:.3f} ms")
    del grad
    torch.cuda.empty_cache()

    # the single-grid field's table: B3 on rows of 4 bytes (2 bf16 features)
    # and B4 on its gradient's 4-byte quarters; then the rows that one rank
    # of four builds under the feature-sharded table (table_layout "tp": 8
    # of the 32 logical tables, [E, 16] bf16, 32-byte rows) and its
    # gradient's quarters. Each timed over QUAD_SMALL_ITERS calls: a narrow
    # call's wrapper takes about as long on the host as its kernel on the
    # card, so B3/B4 narrow also print their device time under torch.profiler
    # the single grid's column of one feature, what each of two ranks holds
    # under the feature-sharded layout ([E, 1]: 2-byte rows and quarters in
    # bf16, quad_build_half_kernel / quad_fold_half_kernel; 4-byte ones in
    # f32, the narrow kernels), timed the same way
    sg_levels = single_grid_levels()
    for key, lv, width, dtype, device_kernel in (
            ("narrow", sg_levels, 2, torch.bfloat16, "narrow"),
            ("sharded", levels, 16, torch.bfloat16, None),
            ("column", sg_levels, 1, torch.bfloat16, "half"),
            ("column_f32", sg_levels, 1, torch.float32, "narrow")):
        table = ((torch.rand(lv.total_entries, width, generator=gen,
                             device=device) - 0.5) * 2e-4).to(dtype)
        grad = ((torch.rand(lv.total_entries, 4 * width, generator=gen,
                            device=device) - 0.5) * 2e-3).to(dtype)
        for kernel, what, x, run, plain_fn in (
                ("quad_build", "B3 quad_build", table, quad_kernel.quad_build_cuda,
                 quad_kernel.quad_build_plain),
                ("quad_fold", "B4 quad_fold", grad, quad_kernel.quad_fold_cuda,
                 quad_kernel.quad_fold_plain)):
            out, plain = run(x, lv), plain_fn(x, lv)
            torch.cuda.synchronize()
            if not torch.equal(out, plain):
                raise AssertionError(f"{what} on {key} rows differs from its plain version")
            shape = tuple(out.shape)
            del out, plain
            k_ms = cuda_time_ms(lambda: run(x, lv), QUAD_SMALL_ITERS)
            p_ms = cuda_time_ms(lambda: plain_fn(x, lv))
            l_ms = quad_library_ms(x, lv, f"{key} rows") if kernel == "quad_build" else None
            moved = x.numel() * x.element_size() * (5 if kernel == "quad_build" else 1.25)
            bound = bound_ms(moved)
            device_ms = kernel_device_ms(
                lambda: run(x, lv), f"{kernel}_{device_kernel}_kernel",
                QUAD_SMALL_ITERS) if device_kernel else None
            results[kernel].update({f"{key}_shape": list(x.shape), f"{key}_ms": k_ms,
                                    f"{key}_plain_ms": p_ms, f"{key}_bound_ms": bound[0],
                                    f"{key}_library_ms": l_ms})
            if device_ms is not None:
                results[kernel][f"{key}_device_ms"] = device_ms
            log("kernels", f"{what} {key} rows {tuple(x.shape)} -> {shape} "
                           f"{str(dtype)[6:]}: bit-exact; kernel {k_ms:.4f} ms "
                           f"({moved / k_ms / 1e6:.0f} GB/s, bound {bound[0]:.4f} ms, "
                           f"{100 * bound[0] / k_ms:.1f}% of it), plain {p_ms:.3f} ms"
                           + (f", device time {device_ms:.4f} ms ({device_kernel} kernel, "
                              f"{100 * bound[0] / device_ms:.1f}% of the bound)"
                              if device_ms else "")
                           + (f", index_select {l_ms:.4f} ms" if l_ms is not None else ""))
        del table, grad
        torch.cuda.empty_cache()

    def check_mlp(name, d_in, d_out, n_layers, w, skips, bias, act):
        """B1-fwd and B2 on one MLP at MLP_ROWS rows against their plain
        versions; returns ((err, ms, plain ms, bound) forward, the same
        backward)."""
        params = ParamTree(init_mlp(gen, d_in, d_out, n_layers, w, skips, bias))
        x = torch.randn(MLP_ROWS, d_in, generator=gen, device=device)
        out = fused_mlp.fused_mlp_cuda(params, x, act, skips)
        ref = fused_mlp.fused_mlp_plain(params, x, act, torch.bfloat16, skips)
        e = fused_mlp.compare_to_plain(out, ref)
        macs = sum(layer.w.numel() for layer in params.layers)
        weight_bytes = 4 * sum(p.numel() for p in params.parameters())
        fwd_bytes = MLP_ROWS * (d_in + d_out) * 4 + weight_bytes
        fwd_flops = 2 * macs * MLP_ROWS
        fwd_bound = bound_ms(fwd_bytes, bf16_flops=fwd_flops)
        run = lambda: fused_mlp.fused_mlp_cuda(params, x, act, skips)  # noqa: E731
        e_ms = cuda_time_ms(run)
        k_ms = kernel_device_ms(run, "fused_mlp_fwd_kernel")
        p_ms = cuda_time_ms(lambda: fused_mlp.fused_mlp_plain(
            params, x, act, torch.bfloat16, skips))
        log("kernels", f"B1-fwd {name} [{MLP_ROWS}, {d_in}] -> [{MLP_ROWS}, {d_out}]: "
                       f"max abs err {e['max_abs']:.3e} (tol {e['max_tol']:.3e}; "
                       f"{e['max_rel']:.3e} of max |plain|), "
                       f"mean abs err {e['mean_abs']:.3e} (tol {e['mean_tol']:.3e}); "
                       f"kernel {k_ms:.4f} ms on the device ({fwd_flops / k_ms / 1e9:.1f} "
                       f"TFLOP/s, {fwd_bytes / k_ms / 1e6:.0f} GB/s; bound "
                       f"{fwd_bound[0]:.4f} ms, {fwd_bound[1]}, "
                       f"{100 * fwd_bound[0] / k_ms:.1f}% of it), {e_ms:.4f} ms per "
                       f"call by CUDA events; plain {p_ms:.3f} ms")
        if name == "stem":  # for information: does fusing pay on this card?
            u_ms = cuda_time_ms(lambda: unfused_chain(params, x, act, skips))
            log("kernels", f"B1-fwd stem for information: six bf16 torch.matmul "
                           f"products with bias, relu and concat, unfused, "
                           f"{u_ms:.4f} ms ({fwd_flops / u_ms / 1e9:.1f} TFLOP/s); "
                           f"the kernel takes {k_ms / u_ms:.2f}x its time")
        fwd = (e["max_abs"], k_ms, p_ms, fwd_bound)

        fused_mlp.positive_(params, gen)
        x = fused_mlp.positive_input(MLP_ROWS, d_in, gen)
        g = fused_mlp.positive_input(MLP_ROWS, d_out, gen)
        outs = fused_mlp.fused_mlp_bwd_cuda(params, x, g, act, skips)
        refs = fused_mlp.fused_mlp_bwd_plain(params, x, g, act, torch.bfloat16, skips)
        torch.cuda.synchronize()
        e = fused_mlp.compare_bwd_to_plain(outs, refs)
        k_ms = cuda_time_ms(lambda: fused_mlp.fused_mlp_bwd_cuda(params, x, g, act, skips))
        p_ms = cuda_time_ms(lambda: fused_mlp.fused_mlp_bwd_plain(
            params, x, g, act, torch.bfloat16, skips))
        gflop = 6 * macs * MLP_ROWS / 1e9  # forward recompute, dW, dh
        # reads x, g and the weights, writes dx and every dW and db; every
        # product of the bf16 split on the tensor cores (the bound); the
        # same with the per-block partials' traffic; the f32-product route
        work = fused_mlp.bwd_work(params, MLP_ROWS, n_parts)
        bwd_bound = bound_ms(work["bytes"], bf16_flops=work["bf16_flops"])
        with_parts = bound_ms(work["bytes"] + work["partial_bytes"],
                              bf16_flops=work["bf16_flops"])
        f32_route = bound_ms(work["bytes"], bf16_flops=work["fwd_flops"],
                             f32_flops=work["f32_flops"])
        log("kernels", f"B2 {name} [{MLP_ROWS}, {d_in}] <- [{MLP_ROWS}, {d_out}] "
                       f"(positive_): max abs err {e['max_abs']:.3e} "
                       f"({e['max_rel']:.3e} of max |plain|, tol "
                       f"{fused_mlp.BWD_MAX_ERR_REL:g}), mean abs err "
                       f"{e['mean_abs']:.3e} (tol {fused_mlp.BWD_MEAN_ERR_REL:g} "
                       f"of mean |plain|), worst of dx, dW, db, using "
                       f"{e['max_share']:.3g} / {e['mean_share']:.3g} of the "
                       f"tolerances; kernel {k_ms:.3f} ms ({gflop / k_ms:.0f} "
                       f"TFLOP/s over {gflop:.1f} GFLOP of the function, "
                       f"{work['bf16_flops'] / k_ms / 1e9:.0f} bf16 TFLOP/s run); "
                       f"bound {bwd_bound[0]:.3f} ms "
                       f"({bwd_bound[1]}; the split's "
                       f"{work['bf16_flops'] / 1e9:.0f} bf16 GFLOP), "
                       f"{with_parts[0]:.3f} ms with the partials' "
                       f"{work['partial_bytes'] / 1e9:.2f} GB, f32-product route "
                       f"{f32_route[0]:.3f} ms; plain {p_ms:.3f} ms")
        return fwd, (e["max_abs"], k_ms, p_ms, bwd_bound)

    # summed over the stem, base and head: max err, ms, plain ms, then the
    # bound of each launch (the larger of bytes and operations) summed
    sums = {"fused_mlp_fwd": [], "fused_mlp_bwd": []}
    for name, shape in mlp_shapes(cfg).items():
        for kernel, entry in zip(sums, check_mlp(name, *shape)):
            sums[kernel].append(entry)
    for kernel, entries in sums.items():
        bounds = [b for *_, b in entries]
        largest = max(bounds)  # the stem's: it names what bounds the sum
        results[kernel] = kernel_entry(max(e[0] for e in entries),
                                       sum(e[1] for e in entries),
                                       sum(e[2] for e in entries),
                                       (sum(b[0] for b in bounds), largest[1]))
    # the colour head at the other configurations' input widths
    head = mlp_shapes(cfg)["head"]
    for kernel in sums:
        results[kernel]["variant_heads"] = []
    for what, d_in in VARIANT_HEAD_WIDTHS.items():
        for kernel, (err, k_ms, p_ms, bound) in zip(
                sums, check_mlp(f"head ({what})", d_in, *head[1:])):
            results[kernel]["variant_heads"].append(
                {"d_in": d_in, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                 "bound_ms": bound[0], "bound_by": bound[1]})
            log("kernels", f"{'B1-fwd' if kernel == 'fused_mlp_fwd' else 'B2'} head "
                           f"at d_in {d_in} ({what}): {k_ms:.4f} ms, "
                           f"{100 * bound[0] / k_ms:.1f}% of its bound {bound[0]:.4f} ms")
    torch.cuda.empty_cache()
    return results


def encode_inputs(levels, table, n, fl, with_code, gen):
    """A3's inputs for n samples on ``table``'s card: half the positions
    uniform over the box, a quarter in the grid's centre block, a quarter
    at the origin (the positions the field's selector zeroes: every level's
    corner there collects them); codes at the time embedding's contrast
    scale (utils/cameras.CONTRAST_SCALES) and an output gradient N(0, 1).
    Returns (fwd_args, gbar)."""
    import torch
    from nersemble_tpu_torch.ops.hash_encoding import hash_grid_indices
    from nersemble_tpu_torch.utils.cameras import CONTRAST_SCALES

    device = table.device
    x = torch.rand(n, 3, generator=gen, device=device)
    q = n // 4
    x[2 * q:3 * q] = 0.375 + 0.25 * x[2 * q:3 * q]
    x[3 * q:] = 0.0
    entry_idx, wy, fx, fz = hash_grid_indices(x, levels)
    h = table.shape[1] // 4 // fl
    code = (torch.randn(n, h, generator=gen, device=device)
            * ENCODE_CODE_STD * CONTRAST_SCALES["time_embedding"]) if with_code else None
    gbar = torch.randn(n, levels.n_levels * fl, generator=gen, device=device)
    return (table, code, wy, fx.contiguous(), fz.contiguous(), entry_idx,
            levels.n_levels, fl, True), gbar


def encode_kernel_phase(cfg, levels, device):
    """A3-fwd and A3-bwd against their plain versions (ENCODE_CASES); returns
    {kernel: kernel_entry(...)} for the flagship table at the bench's
    budget, with every case's numbers under "cases"."""
    import torch
    from nersemble_tpu_torch.ops import hash_encoding as he
    from nersemble_tpu_torch.utils.timing import bound_ms, cuda_time_ms

    gen = torch.Generator(device=device).manual_seed(SEED)
    sg_levels = single_grid_levels()
    results = {"blended_encode_fwd": None, "blended_encode_bwd": None}
    cases = {"blended_encode_fwd": [], "blended_encode_bwd": []}
    for what, width, dtype, n, single in ENCODE_CASES:
        lv = sg_levels if single else levels
        dt = getattr(torch, dtype)
        table = ((torch.rand(lv.total_entries, width, generator=gen, device=device)
                  - 0.5) * 2e-4 * 3e3).to(dt)  # the contrast-scaled table's range
        fl = width // 4 if single else 2
        args, gbar = encode_inputs(lv, table, n, fl, not single, gen)
        _, code, wy, fx, fz, entry_idx = args[:6]
        shape = tuple(table.shape)

        ours = he.blended_encode_fwd_cuda(*args)
        refs = he.blended_encode_fwd_plain(*args)
        f_err = he.compare_to_plain(ours, refs, ("out", "CG", "BH"))
        if not all(a is None or torch.equal(a, b) for a, b in zip(ours[1:], refs[1:])):
            raise AssertionError(f"A3-fwd {what}: CG or BH differs from the plain "
                                 f"version's bits")
        out_bits = torch.equal(ours[0], refs[0])
        del refs
        grads = [he.blended_encode_bwd_cuda(gbar, ours[1], ours[2], code, entry_idx,
                                            wy, fx, fz, shape) for _ in range(2)]
        torch.cuda.synchronize()
        if not all(a is None and b is None or torch.equal(a, b) for a, b in zip(*grads)):
            raise AssertionError(f"A3-bwd {what}: two runs on the same inputs differ")
        ref_grads = he.blended_encode_bwd_plain(gbar, ours[1], ours[2], code, entry_idx,
                                                wy, fx, fz, shape)
        b_err = he.compare_to_plain(grads[0][1:], ref_grads[1:],
                                    ("d_code", "d_wy", "d_fx", "d_fz"))
        t_err = he.compare_table_grads(grads[0][0], ref_grads[0], *he.table_grad_mass(
            gbar, code, entry_idx, wy, fx, fz, shape, dt))
        t_abs = float((grads[0][0].float() - ref_grads[0].float()).abs().max())
        del grads, ref_grads
        torch.cuda.empty_cache()

        fwd = lambda: he.blended_encode_fwd_cuda(*args)  # noqa: E731
        bwd = lambda: he.blended_encode_bwd_cuda(  # noqa: E731
            gbar, ours[1], ours[2], code, entry_idx, wy, fx, fz, shape)
        fk, fp = cuda_time_ms(fwd), cuda_time_ms(lambda: he.blended_encode_fwd_plain(*args))
        bk = cuda_time_ms(bwd)
        # a one-feature forward is a ~40 us kernel: its wrapper's host time
        # is comparable, so its device time too, and the backward's kernels'
        fd = kernel_device_ms(fwd, "be_fwd_narrow_kernel") if width == 4 else None
        bd = kernels_device_ms(bwd, COLUMN_BWD_KERNELS) if width == 4 else None
        bp = cuda_time_ms(lambda: he.blended_encode_bwd_plain(
            gbar, ours[1], ours[2], code, entry_idx, wy, fx, fz, shape))
        parts = encode_bwd_parts(he, (gbar, ours[1], ours[2], code, entry_idx, wy, fx,
                                      fz, shape), bk)
        # the scatter alone: index_add_ of the f32 rows
        acc = torch.zeros(shape, dtype=torch.float32, device=device)
        rows = torch.randn(entry_idx.numel(), shape[1], generator=gen, device=device)
        flat = entry_idx.reshape(-1)
        lib = cuda_time_ms(lambda: acc.index_add_(0, flat, rows))
        del acc, rows
        # bytes: each input read once (the table: each distinct row gathered),
        # each output written once
        es = table.element_size()
        distinct = int(torch.unique(entry_idx).numel())
        per_sample = sum(t.numel() * t.element_size()
                         for t in (wy, fx, fz, entry_idx) + ((code,) if code is not None else ()))
        residuals = sum(t.numel() * t.element_size() for t in ours[1:] if t is not None)
        out_bytes = ours[0].numel() * 4
        f_bound = bound_ms(distinct * shape[1] * es + per_sample + out_bytes + residuals)
        b_bound = bound_ms(out_bytes + residuals + 2 * per_sample
                           - entry_idx.numel() * entry_idx.element_size()
                           + shape[0] * shape[1] * es)
        gathered_gb = entry_idx.numel() * shape[1] * es / 1e9
        for kernel, k_ms, p_ms, bound, errs, l_ms in (
                ("blended_encode_fwd", fk, fp, f_bound, f_err, None),
                ("blended_encode_bwd", bk, bp, b_bound, {**b_err, "d_table": {
                    "max_abs": t_abs, **t_err}}, lib)):
            err = max(e["max_abs"] for e in errs.values())
            entry = kernel_entry(err, k_ms, p_ms, bound, l_ms)
            extra = {"parts": parts} if kernel.endswith("bwd") else {"out_bit_for_bit": out_bits}
            if fd is not None and kernel.endswith("fwd"):
                extra["device_ms"] = fd
            if bd is not None and kernel.endswith("bwd"):
                extra["device_ms"] = bd
            cases[kernel].append({"case": what, "samples": n, "table": list(shape),
                                  "dtype": dtype, **entry, **extra})
            if results[kernel] is None:
                results[kernel] = entry
            log("kernels", f"{'A3-fwd' if kernel.endswith('fwd') else 'A3-bwd'} "
                           f"{what} {list(shape)} {dtype} at {n} samples: kernel "
                           f"{k_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
                           f"{100 * bound[0] / k_ms:.1f}% of it; plain {p_ms:.3f} ms"
                           + (f"; index_add_ of the f32 rows alone {l_ms:.4f} ms"
                              if l_ms is not None else "")
                           + (f"; device time {fd:.4f} ms ({100 * bound[0] / fd:.1f}% "
                              f"of the bound)" if fd is not None and kernel.endswith("fwd")
                              else ""))
        log("kernels", f"A3 {what}: {distinct} distinct rows of "
                       f"{entry_idx.numel()} gathered ({gathered_gb:.3f} GB gathered); "
                       f"CG and BH bit for bit, out "
                       f"{'bit for bit' if out_bits else 'within the bounds'}; "
                       f"forward against plain, share of the max / mean bounds "
                       + ", ".join(f"{k} {e['max_abs'] / max(e['max_tol'], 1e-38):.3g} / "
                                   f"{e['mean_abs'] / max(e['mean_tol'], 1e-38):.3g}"
                                   for k, e in f_err.items())
                       + "; backward " + ", ".join(
                           f"{k} {e['max_abs'] / max(e['max_tol'], 1e-38):.3g} / "
                           f"{e['mean_abs'] / max(e['mean_tol'], 1e-38):.3g}"
                           for k, e in b_err.items())
                       + f"; table gradient {t_err['unequal']} of {t_err['entries']} "
                         f"entries unequal, {t_err['past_one_ulp']} past one ulp (at "
                         f"most {t_err['max_ulps']:.3g}, where rows cancel), "
                         f"{t_err['max_share']:.3g} of the bound; A3-bwd twice: "
                         f"bit for bit")
        log("kernels", f"A3-bwd {what} parts alone, their serial sum and the "
                       f"wrapper's wall"
                       + " (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
        if bd is not None:
            log("kernels", f"A3-bwd {what} kernels' device time per call (ms): "
                           + ", ".join(f"{k} {v:.4f}" for k, v in bd.items()))
        del table, args, gbar, ours, code, wy, fx, fz, entry_idx
        torch.cuda.empty_cache()
    for kernel in results:
        results[kernel]["cases"] = cases[kernel]
    encode_digest_check(device)
    return results


def encode_bwd_parts(he, bwd_args, wall_ms: float) -> dict:
    """A3-bwd's parts (``BlendedBwdPlan.parts``), each timed alone on the
    current stream (ms): the sort of the entry keys, the per-sample kernel,
    the table's zeros, the chunk walk and the spanning runs; on quad rows of
    4 elements the per-sample kernel, the counting sort's passes (``order``)
    and the reduce. And the wrapper's wall time (every part, the zeros
    included, on the current stream)."""
    from nersemble_tpu_torch.utils.timing import cuda_time_ms

    plan = he.BlendedBwdPlan(*bwd_args)
    parts = {name: cuda_time_ms(part) for name, part in plan.parts().items()}
    parts["serial_sum"] = sum(parts.values())
    parts["wall"] = wall_ms
    del plan
    return parts


def encode_digest_check(device) -> None:
    """The flagship case's outputs of A3-fwd and A3-bwd against the
    digests of the kernels of commit 77061aa on the same inputs, and the
    column case's (bf16 and f32) against those of commit a38561d
    (scripts/encode_digests.py): the redesigned kernels sum in the same
    orders, so every digest must match."""
    import torch
    from nersemble_tpu_torch.scripts.encode_digests import column_digests, flagship_digests

    for case, ours, theirs in (("flagship", flagship_digests(device), A3_DIGESTS),
                               *((f"column {dtype}", digests, A3_COLUMN_DIGESTS[dtype])
                                 for dtype, digests in column_digests(device).items())):
        torch.cuda.empty_cache()
        differ = sorted(k for k, v in theirs.items() if ours.get(k) != v)
        if differ or set(ours) != set(theirs):
            raise AssertionError(f"A3 on the {case} digest case: {differ} differ from "
                                 f"the earlier kernels' digests: {ours}")
        log("kernels", f"A3 {case} digest case: {len(ours)} outputs "
                       f"({', '.join(ours)}) equal the earlier kernels' SHA-256 bit for bit")


def train_phase(cfg, device):
    """The flagship training step; returns (the launch counts of the phase,
    ms/step)."""
    import torch
    from nersemble_tpu_torch.bench import LRS
    from nersemble_tpu_torch.config import OptimizerConfig
    from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
    from nersemble_tpu_torch.ops import fused_mlp, launch_counts
    from nersemble_tpu_torch.ops.sampling import quantized_budget
    from nersemble_tpu_torch.utils.bench_data import (
        STEADY_STATE_FILL,
        bench_batch,
        bench_grid,
    )

    optimizers = {name: OptimizerConfig(lr=lr, scheduler_gamma=1.0)
                  for name, lr in LRS.items()}
    grid = bench_grid(cfg.grid_resolution)
    trainer = NeRSembleTrainer(cfg, TRAIN_RAYS, optimizers, seed=SEED,
                               device=device, grid_occs=grid.to(device))
    S = cfg.sampling.max_samples_per_ray
    trainer._budget = quantized_budget(STEADY_STATE_FILL, TRAIN_RAYS, S)  # 73,728
    batch = bench_batch(TRAIN_RAYS, cfg.n_timesteps, cfg.grid_resolution, device)
    # steps past the schedule's end (window_deform 7, window_hash 32,
    # eps_depth 0.01), off the occupancy (16) and budget (125) cadences
    step0 = cfg.window_hash_encodings_end + 1
    log("train", f"flagship: {TRAIN_RAYS} rays, S={S}, budget {trainer._budget}, "
                 f"chunk cap {cfg.max_n_samples_per_batch}, steps from {step0}: "
                 f"{trainer.sched_values(step0)}, lrs {trainer.lr_values(step0)}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts.reset()
    start = time.perf_counter()
    first, aux0 = trainer.run_step(step0, batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - start
    totals, auxes = [], []
    fused_mlp.ROWS = collections.Counter()
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        start = time.perf_counter()
        for i in range(TRAIN_STEPS):
            total, aux = trainer.run_step(step0 + 1 + i, batch)
            totals.append(total)
            auxes.append(aux)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in syncs if "called a synchronizing" in str(w.message)]
    step_rows, fused_mlp.ROWS = fused_mlp.ROWS, collections.Counter()
    start = time.perf_counter()
    occ_step = step0 - 1 + 16
    trainer.maybe_update_occupancy(occ_step)
    torch.cuda.synchronize()
    occ_ms = (time.perf_counter() - start) * 1e3
    occ_rows, fused_mlp.ROWS = fused_mlp.ROWS, None
    launches = launch_counts.read()

    values = [float(first)] + [float(t) for t in totals]
    losses = {k: float(v) for k, v in auxes[-1]["losses"].items()}
    step_s = elapsed / TRAIN_STEPS
    valid = float(auxes[-1]["num_samples"])
    dropped = float(auxes[-1]["num_budget_dropped"])
    log("train", f"warm-up step {1e3 * warm_s:.1f} ms; {TRAIN_STEPS} steps "
                 f"{1e3 * step_s:.1f} ms/step, {TRAIN_RAYS / step_s:.0f} rays/s, "
                 f"{valid / step_s:.0f} valid samples/s ({valid:.0f} valid/step), "
                 f"{trainer._budget / step_s:.0f} evaluated samples/s; "
                 f"budget-dropped {dropped:.0f}/step; peak memory "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                 f"host syncs in the timed steps: {len(syncs)}")
    for w in syncs[:3]:
        log("train", f"sync: {str(w.message)[:160]} ({w.filename}:{w.lineno})")
    if syncs:  # ROADMAP C5: a host read inside the step drains the GPU's queue
        raise AssertionError(f"{len(syncs)} synchronizing operations in the timed steps")
    log("train", f"occupancy update (sampled, step {occ_step}): {occ_ms:.1f} ms; "
                 f"grid fill {float(trainer.model.binaries(trainer.grid_occs).float().mean()):.4f}")
    rows_histogram(f"train: {TRAIN_STEPS} timed steps", cfg, step_rows)
    rows_histogram("train: occupancy update", cfg, occ_rows)
    log("train", f"loss per step {[round(v, 6) for v in values]}; last step {losses}; "
                 f"psnr {float(auxes[-1]['psnr']):.3f}; launches {launches}")
    if not all(math.isfinite(v) for v in values + list(losses.values())):
        raise AssertionError(f"non-finite loss: {values} {losses}")
    if not values[-1] < values[0]:
        raise AssertionError(f"the loss did not fall: {values}")
    for kernel, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the training path never launched {kernel}")

    profile_run("train profile", lambda: trainer.run_step(step0 + 1 + TRAIN_STEPS, batch),
                TRAIN_RANGES, "step")
    return launches, 1e3 * step_s


def tiny_train_grads(cfg, params, device):
    """One tiny-config training forward + backward on ``device``: (losses,
    gradients by state_dict key), both on the CPU."""
    import torch
    from nersemble_tpu_torch.models.nersemble import NeRSembleModel

    model = NeRSembleModel(cfg, device)
    p = copy.deepcopy(params).to(device)  # Module.to moves in place
    for q in p.parameters():
        q.requires_grad_(True)
    rng = np.random.default_rng(0)
    n_cells = model.init_grid_occs().numel()
    occ = torch.from_numpy((rng.uniform(size=n_cells) < 0.3).astype(np.float32))
    d = rng.normal(size=(256, 3)) * [0.05, 0.3, 0.3] + [1.0, 0.0, 0.0]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = {"origins": torch.tensor([[-8.0, 0.0, 0.0]]).repeat(256, 1),
             "directions": torch.from_numpy(d.astype(np.float32)),
             "timesteps": torch.from_numpy(rng.integers(0, 8, 256)),
             "rgb": torch.from_numpy(rng.uniform(size=(256, 3)).astype(np.float32)),
             "alpha": torch.from_numpy(rng.uniform(size=256).astype(np.float32)),
             "depth": torch.from_numpy(rng.uniform(7.5, 9.5, 256).astype(np.float32))}
    jitter = torch.from_numpy(rng.uniform(size=256).astype(np.float32)).to(device)
    batch["camera_indices"] = torch.from_numpy(rng.integers(0, max(cfg.num_images, 1), 256))
    batch = {k: v.to(device) for k, v in batch.items()}
    sched = {"window_deform": 7.0, "window_hash": 8.0, "eps_depth": 0.3}
    out = model.render_rays(p, batch, model.binaries(occ.to(device)), sched,
                            train=True, budget=2048, jitter=jitter)
    losses = model.compute_losses(out, batch, sched, train=True)
    sum(losses.values()).backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {k: torch.zeros(q.shape) if q.grad is None else q.grad.cpu()
             for k, q in p.named_parameters()})


def tiny_config(variant=None):
    """The tiny flagship config (training at half the slots' budget), with
    the edits of ``TINY_VARIANTS[variant]``; and its contrast-scaled random
    parameters on the CPU."""
    import torch
    from nersemble_tpu_torch.config import flagship_model_config
    from nersemble_tpu_torch.models.nersemble import NeRSembleModel
    from nersemble_tpu_torch.utils.cameras import add_contrast

    cfg = flagship_model_config(tiny=True)
    cfg.sampling.global_budget_fraction = 0.5
    for edit in TINY_VARIANTS.get(variant, ()):
        edit(cfg)
    params = add_contrast(NeRSembleModel(cfg, "cpu").init_params(
        torch.Generator().manual_seed(SEED)))
    return cfg, params


def train_reference_phase(device, variant=None, phase="train reference") -> None:
    """The tiny step on ``device`` vs the port's CPU path (TRAIN_REF_TOL)."""
    cfg, params = tiny_config(variant)
    ref_losses, ref_grads = tiny_train_grads(cfg, params, "cpu")
    losses, grads = tiny_train_grads(cfg, params, device)
    loss_err = max(abs(losses[k] - ref_losses[k]) / max(abs(ref_losses[k]), 1e-30)
                   for k in ref_losses)
    worst = {}
    for k, ref in ref_grads.items():
        scale = float(ref.abs().max())
        atol = (TRAIN_REF_TOL["table_atol"] if k == "field.table"
                else TRAIN_REF_TOL["atol"]) * scale
        excess = (grads[k] - ref).abs() - TRAIN_REF_TOL["rtol"] * ref.abs()
        if scale > 0:
            worst[k] = float(excess.max()) / atol
        else:  # a leaf the loss does not reach
            worst[k] = 0.0 if float(grads[k].abs().max()) == 0 else math.inf
    log(phase, f"tiny step GPU vs CPU: losses max rel err {loss_err:.2e} "
               f"(tol {TRAIN_REF_TOL['loss_rtol']:g}); gradient leaves, "
               f"worst (|err| - rtol*|ref|) / atol: "
               f"{max(worst.values()):.3f} at {max(worst, key=worst.get)} "
               f"(pass <= 1)")
    if not loss_err <= TRAIN_REF_TOL["loss_rtol"]:
        raise AssertionError(f"GPU losses {losses} vs CPU {ref_losses}")
    if not max(worst.values()) <= 1.0:
        raise AssertionError(f"GPU gradients differ from the CPU path: {worst}")


def frame_reference(device, variant=None, phase="variants") -> None:
    """A REF_W x REF_H frame of the tiny config (with a variant's edits) on
    ``device`` vs the port's CPU path, within REF_TOL."""
    import torch
    from nersemble_tpu_torch.engine.renderer import Renderer
    from nersemble_tpu_torch.models.nersemble import NeRSembleModel
    from nersemble_tpu_torch.utils.cameras import pinhole_frame, synthetic_occupancy

    cfg, params = tiny_config(variant)
    grid = torch.from_numpy(np.concatenate([
        synthetic_occupancy(cfg.grid_resolution, 0.3, seed=level)
        for level in range(cfg.grid_levels)]))
    frame = pinhole_frame(REF_H, REF_W, TIMESTEPS[1])
    images = {}
    for dev in (device, "cpu"):
        renderer = Renderer(NeRSembleModel(cfg, dev), copy.deepcopy(params).to(dev),
                            grid.to(dev))
        images[str(dev)] = renderer.render_image(frame, cfg.window_hash_encodings_end,
                                                 chunk=REF_CHUNK)
    ours, ref = images[str(device)], images["cpu"]
    errs = {key: float(np.abs(ours[key] - ref[key]).max()) for key in ref}
    log(phase, f"{REF_W}x{REF_H} frame GPU vs CPU max abs err {errs} (tol {REF_TOL}); "
               f"accumulation max {ref['accumulation'].max():.4f}")
    if not ref["accumulation"].max() > 0.01:
        raise AssertionError(f"{variant}: the reference frame is empty")
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], **REF_TOL,
                                   err_msg=f"{variant} {key}")


def copy_kernel_phase(levels, device):
    """P1-P4 vs their plain versions, bit-exact, at the measurement path's
    shapes; returns {kernel: kernel_entry(...)}."""
    import torch
    from nersemble_tpu_torch.ops import copy_kernels as ck
    from nersemble_tpu_torch.scripts import gather_probe
    from nersemble_tpu_torch.utils.timing import bound_ms, cuda_time_ms

    gen = torch.Generator(device=device).manual_seed(SEED)
    results = {}

    def check(name, note, kernel, plain, library, n_bytes):
        out, ref, lib = kernel(), plain(), library()
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"{name} kernel differs from its plain version")
        if not torch.equal(lib, ref):
            raise AssertionError(f"{name}: the library call computes another function")
        err = float((out.float() - ref.float()).abs().max())
        del out, ref, lib
        torch.cuda.empty_cache()
        k_ms, p_ms, l_ms = (cuda_time_ms(fn) for fn in (kernel, plain, library))
        results[name] = kernel_entry(err, k_ms, p_ms, bound_ms(n_bytes), l_ms)
        b_ms = results[name]["bound_ms"]
        log("copy kernels", f"{name} {note}: bit-exact; kernel {k_ms:.3f} ms "
                            f"({n_bytes / k_ms / 1e6:.0f} GB/s over {n_bytes / 1e9:.3f} "
                            f"GB; bound {b_ms:.3f} ms, {100 * b_ms / k_ms:.1f}% of it), "
                            f"plain {p_ms:.3f} ms, library {l_ms:.3f} ms")

    E, W, N = gather_probe.ENTRIES, gather_probe.WIDTH, gather_probe.ROWS
    depth = ck.DEFAULT_DEPTH
    table = torch.rand(E, W, generator=gen, device=device).to(torch.bfloat16)
    idx = torch.randint(0, E, (N,), generator=gen, device=device, dtype=torch.int32)
    check("gather_rows", f"[{E}, {W}] bf16 x {N} int32 rows, depth {depth}",
          lambda: ck.gather_rows_cuda(table, idx, depth),
          lambda: ck.gather_rows_plain(table, idx),
          lambda: table.index_select(0, idx),
          N * idx.element_size() + 2 * N * W * table.element_size())
    del table, idx

    x = torch.randn(levels.total_entries, 64, generator=gen,
                    device=device).to(torch.bfloat16)
    x_bytes = x.numel() * x.element_size()
    # P4 is held on seven distinct inputs, which shows which four it stores,
    # and timed as the ladder runs it, on one input passed seven times (each
    # distinct byte counts once).
    distinct = [x] + [torch.randn(x.shape, generator=gen, device=device)
                      .to(torch.bfloat16) for _ in range(6)]
    out = ck.fetch7_cuda(*distinct)
    if not (torch.equal(out, ck.fetch7_plain(*distinct)) and torch.equal(
            out, torch.cat([distinct[i] for i in (0, 1, 3, 5)], dim=1))):
        raise AssertionError("fetch7 kernel differs from its plain version on "
                             "seven distinct inputs")
    del out, distinct
    torch.cuda.empty_cache()
    log("copy kernels", "fetch7 on seven distinct inputs: bit-exact against its "
                        "plain version and torch.cat of inputs 0, 1, 3, 5")
    seven = [x] * 7
    note = f"{tuple(x.shape)} bf16, block {ck.BLOCK} rows"
    check("copy", note, lambda: ck.copy_cuda(x), lambda: ck.copy_plain(x),
          lambda: x.clone(), 2 * x_bytes)
    # P2 and clone() in turns, on the same input after the same allocations:
    # the copy's numbers (a time taken first after empty_cache() reads slow)
    rounds = []
    for r in range(COPY_ROUNDS):
        rounds.append((cuda_time_ms(lambda: ck.copy_cuda(x)),
                       cuda_time_ms(lambda: x.clone())))
        log("copy kernels", f"copy round {r}: kernel {rounds[-1][0]:.3f} ms, clone "
                            f"{rounds[-1][1]:.3f} ms ({100 * (rounds[-1][0] / rounds[-1][1] - 1):+.1f}%)")
    results["copy"]["ms"] = sum(k for k, _ in rounds) / COPY_ROUNDS
    results["copy"]["library_ms"] = sum(l for _, l in rounds) / COPY_ROUNDS
    check("bcast_quarters", note, lambda: ck.bcast_quarters_cuda(x),
          lambda: ck.bcast_quarters_plain(x), lambda: x.repeat(1, 4), 5 * x_bytes)
    check("fetch7", note, lambda: ck.fetch7_cuda(*seven),
          lambda: ck.fetch7_plain(*seven),
          lambda: torch.cat([seven[0], seven[1], seven[3], seven[5]], dim=1),
          5 * x_bytes)
    del x, seven
    torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def plain_adam():
    """``ops/fused_adam.adam_update`` swapped for its plain version, which
    runs on any device."""
    from nersemble_tpu_torch.ops import fused_adam

    def plain(leaves, *args):
        for leaf in leaves:
            fused_adam.adam_update_plain(*leaf, *args)

    kernel, fused_adam.adam_update = fused_adam.adam_update, plain
    try:
        yield
    finally:
        fused_adam.adam_update = kernel


def adam_flagship(device):
    """The flagship's parameters (seeded), a fresh Adam state and its
    three groups' key_to_group."""
    import torch
    from nersemble_tpu_torch.config import flagship_model_config
    from nersemble_tpu_torch.engine.optimizers import group_of_param, init_adam
    from nersemble_tpu_torch.models.nersemble import NeRSembleModel

    model = NeRSembleModel(flagship_model_config(tiny=False), device)
    params = model.init_params(torch.Generator(device=device).manual_seed(SEED))
    return params, init_adam(params), group_of_param(model.param_groups(params))


def adam_steps(params, state, key_to_group, steps=ADAM_STEPS, shards=None,
               skip=(), g_dtypes=None, plain=False):
    """``steps`` Adam steps through ``engine/optimizers.fused_adam_update``
    on seeded gradients, drawn on the state's card step by step and leaf by
    leaf in the moments' shapes, at scales 1 to 1e-6; returns the state.
    ``shards`` {name: rows}: leaves stepped on those rows (``row_shards``),
    their gradient in ``g_dtypes[name]`` if given; ``skip``: leaves without
    a gradient. ``plain``: the plain update in the kernel's place."""
    import torch
    from nersemble_tpu_torch.engine.optimizers import fused_adam_update

    device = state.count.device
    shards, g_dtypes = shards or {}, g_dtypes or {}
    mus = dict(state.mu.named_parameters())
    with plain_adam() if plain else contextlib.nullcontext():
        for step in range(steps):
            gen = torch.Generator(device=device).manual_seed(1000 + step)
            row_shards = {}
            for i, (name, p) in enumerate(params.named_parameters()):
                p.grad = None
                if name in skip:
                    continue
                g = torch.randn(mus[name].shape, generator=gen, device=device)
                g = (g * 10.0 ** -(i % 7)).to(g_dtypes.get(name, torch.float32))
                if name in shards:
                    row_shards[name] = (shards[name], g)
                else:
                    p.grad = g
            state = fused_adam_update(params, state, key_to_group, ADAM_LRS,
                                      row_shards=row_shards)
    return state


def adam_digest(params, state) -> str:
    """SHA-256 of every parameter and both moments, leaf by leaf."""
    digest = hashlib.sha256()
    for tree in (params, state.mu, state.nu):
        for _, value in tree.named_parameters():
            digest.update(value.detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def adam_kernel_phase(device) -> dict:
    """Phase 3c: Adam at the flagship's leaves, the kernel against the
    plain update; returns {"fused_adam": kernel_entry(...)}."""
    import torch
    from nersemble_tpu_torch.engine.optimizers import fused_adam_update
    from nersemble_tpu_torch.ops import fused_adam, launch_counts
    from nersemble_tpu_torch.utils.timing import bound_ms, cuda_time_ms

    params, state, key_to_group = adam_flagship(device)
    n = sum(p.numel() for p in params.parameters())
    state = adam_steps(params, state, key_to_group, plain=True)
    plain_digest = adam_digest(params, state)
    del params, state
    torch.cuda.empty_cache()
    params, state, key_to_group = adam_flagship(device)
    launches = launch_counts.read()["fused_adam"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = adam_steps(params, state, key_to_group)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = launch_counts.read()["fused_adam"] - launches
    digest = adam_digest(params, state)
    log("adam", f"{len(list(params.parameters()))} leaves, {n} elements, "
                f"{ADAM_STEPS} steps: kernel {digest} ({launches} launches), plain "
                f"{plain_digest}")
    if digest != plain_digest:
        raise AssertionError("the Adam kernel differs from the plain update")
    if launches != ADAM_STEPS:
        raise AssertionError(f"the Adam kernel launched {launches} times in "
                             f"{ADAM_STEPS} steps, not once a step")

    def update():  # the last step's gradients again; the state stays
        fused_adam_update(params, state, key_to_group, ADAM_LRS)

    k_ms = cuda_time_ms(update)
    device_ms = kernel_device_ms(update, "fused_adam_kernel")
    with plain_adam():
        p_ms = cuda_time_ms(update, iters=3)
    bound = bound_ms(28 * n)
    log("adam", f"kernel {k_ms:.3f} ms by CUDA events, {device_ms:.3f} ms device; "
                f"bound {bound[0]:.3f} ms ({bound[1]}; {100 * bound[0] / device_ms:.1f}% "
                f"of it by device time); plain update {p_ms:.3f} ms")
    for p in params.parameters():
        p.grad = None
    del params, state
    torch.cuda.empty_cache()
    return {"fused_adam": {**kernel_entry(0.0, k_ms, p_ms, bound),
                           "device_ms": device_ms, "digest": digest}}


def time_code_inputs(n: int, t_rows: int, d: int, per_ray: int, device, seed: int = 0):
    """A seeded gradient [n, d] f32 and its samples' timesteps [n] in ray
    order: rays of ``per_ray`` samples, each ray of one timestep drawn
    uniformly (the compaction keeps a ray's samples together)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn(n, d, generator=gen, device=device)
    rays = torch.randint(0, max(t_rows, 1), (-(-n // per_ray),), generator=gen,
                         device=device)
    return g, rays.repeat_interleave(per_ray)[:n]


def sum_gamma(k: int) -> float:
    """Higham's gamma_k for f32: a sum computed by any tree of additions
    whose longest path from a term to the result has k additions lies within
    gamma_k times the sum of the terms' magnitudes of the exact sum."""
    u = 2.0 ** -24
    return k * u / (1 - k * u)


def time_code_gamma(n: int, t_rows: int, d: int) -> float:
    """gamma_k of the time-code kernel's sums (ops/time_code.py plan): at
    most per_group additions in a group's row, then groups in the block's
    row, then a slice of the blocks and the eight slices in pass 2."""
    from nersemble_tpu_torch.ops import time_code
    p = time_code.plan(n, t_rows, d)
    return sum_gamma(p.per_group + p.groups + -(-p.blocks // time_code.SUM_WARPS)
                     + time_code.SUM_WARPS)


def time_code_check(out, g, idx, t_rows: int, gamma: float) -> float:
    """Raise unless ``out`` lies within ``gamma`` times the row sums of
    |g| of the float64 row sums of ``g``; returns (the largest error, the
    largest error as a share of its bound)."""
    import torch
    ref = torch.zeros(t_rows, g.shape[1], dtype=torch.float64, device=g.device)
    ref.index_add_(0, idx, g.double())
    mag = torch.zeros_like(ref).index_add_(0, idx, g.double().abs())
    err = (out.double() - ref).abs()
    if not bool((err <= gamma * mag).all()):
        raise AssertionError(f"the time-code sums are off by {float(err.max()):.3g}, "
                             f"past gamma {gamma:.3g} of their terms' magnitudes")
    if not err.numel():
        return 0.0, 0.0
    return float(err.max()), float((err / (gamma * mag).clamp_min(1e-300)).max())


def time_code_phase(cfg, device) -> dict:
    """Phase 3d: the time codes' backward kernel alone at the cells' shapes,
    against float64 sums and beside the indexing backward it replaced; then
    its launches in one flagship step at nersemble.train's budget."""
    import torch
    from nersemble_tpu_torch.bench import LRS
    from nersemble_tpu_torch.config import OptimizerConfig
    from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
    from nersemble_tpu_torch.ops import launch_counts, time_code
    from nersemble_tpu_torch.utils.bench_data import bench_batch, bench_grid
    from nersemble_tpu_torch.utils.timing import bound_ms, cuda_time_ms

    results = {}
    for what, n, per_ray in TIME_CODE_CASES:
        for d in TIME_CODE_WIDTHS:
            g, idx = time_code_inputs(n, TIME_CODE_T, d, per_ray, device)
            out = time_code.time_code_bwd_cuda(g, idx, TIME_CODE_T)
            again = time_code.time_code_bwd_cuda(g, idx, TIME_CODE_T)
            err, share = time_code_check(out, g, idx, TIME_CODE_T,
                                         time_code_gamma(n, TIME_CODE_T, d))
            if not torch.equal(out, again):
                raise AssertionError(f"time code {what} D={d}: a second call differs")
            def call():
                return time_code.time_code_bwd_cuda(g, idx, TIME_CODE_T)

            ms = cuda_time_ms(call, iters=20)
            dev = {kernel: kernel_device_ms(call, kernel) for kernel in TIME_CODE_KERNELS}
            dev["sum"] = sum(dev.values())
            lib_ms = cuda_time_ms(lambda: torch.zeros(TIME_CODE_T, d, device=device)
                                  .index_put_((idx,), g, accumulate=True), iters=5)
            bound = bound_ms(4 * n * d + 8 * n + 4 * TIME_CODE_T * d)
            log("time code", f"{what}: {n} samples, D={d}, {time_code.plan(n, TIME_CODE_T, d)}: "
                             f"kernel {ms:.4f} ms by CUDA events, device "
                             f"{dev['sum']:.4f} ({dev['tc_rows_kernel']:.4f} + "
                             f"{dev['tc_sum_kernel']:.4f}); bound {bound[0]:.4f} ms "
                             f"({100 * bound[0] / dev['sum']:.1f}% of it by device time); "
                             f"index_put_ {lib_ms:.3f} ms; max abs error {err:.3g}, "
                             f"{share:.3g} of its bound")
            results[f"{what} D={d}"] = {**kernel_entry(err, ms, None, bound, lib_ms),
                                        "device_ms": dev["sum"], "share_of_gamma": share}
            del g, idx, out, again

    optimizers = {name: OptimizerConfig(lr=lr, scheduler_gamma=1.0)
                  for name, lr in LRS.items()}
    trainer = NeRSembleTrainer(cfg, TRAIN_RAYS, optimizers, seed=SEED, device=device,
                               grid_occs=bench_grid(cfg.grid_resolution).to(device))
    trainer._budget = TIME_CODE_BUDGET
    batch = bench_batch(TRAIN_RAYS, cfg.n_timesteps, cfg.grid_resolution, device)
    step0 = cfg.window_hash_encodings_end + 1  # off the update and budget cadences
    trainer.run_step(step0, batch)
    torch.cuda.synchronize()
    before = launch_counts.read()["time_code_bwd"]
    trainer.run_step(step0 + 1, batch)
    torch.cuda.synchronize()
    launches = launch_counts.read()["time_code_bwd"] - before
    log("time code", f"one flagship step at a budget of {TIME_CODE_BUDGET}: "
                     f"{launches} launches")
    if launches != 4:
        raise AssertionError(f"a flagship step at a budget of {TIME_CODE_BUDGET} launched "
                             f"the time-code kernel {launches} times, not 4 (2 field "
                             f"chunks x 2 codes)")
    del trainer, batch
    torch.cuda.empty_cache()
    first = f"{TIME_CODE_CASES[0][0]} D={TIME_CODE_WIDTHS[-1]}"
    return {"time_code_bwd": {**results[first], "case": first, "cases": results}}


def bench_phase(train_step_ms: float) -> None:
    """The port's train-step bench, in this process."""
    import torch
    from nersemble_tpu_torch import bench
    from nersemble_tpu_torch.ops import launch_counts

    launch_counts.reset()
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        bench.main(["--iters", str(BENCH_ITERS)])
    printed = out.getvalue()
    print(printed, end="", flush=True)
    lines = [line for line in printed.splitlines() if line.startswith("{")]
    if len(lines) != 1:
        raise AssertionError(f"the bench printed {len(lines)} JSON lines")
    result = json.loads(lines[0])
    if set(result) != BENCH_KEYS or set(result["extra"]) != BENCH_EXTRA_KEYS:
        raise AssertionError(f"the bench's keys differ from bench.py's: {result}")
    if not math.isfinite(result["extra"]["loss"]):
        raise AssertionError(f"the bench's loss is not finite: {result}")
    launches = launch_counts.read()
    if min(launches.values()) <= 0:
        raise AssertionError(f"the bench did not launch every kernel: {launches}")
    log("bench", f"{result['extra']['step_ms']} ms/step over {BENCH_ITERS} steps "
                 f"(train phase: {train_step_ms:.1f} ms/step through run_step), "
                 f"{result['value']} rays/s, loss {result['extra']['loss']:.6f}; "
                 f"launches {launches}; "
                 f"{time.perf_counter() - start:.1f} s with set-up")
    torch.cuda.empty_cache()


def diagnostics_phase() -> dict:
    """The measurement scripts, in this process; returns the launch counts
    of P1-P4 on this path."""
    import torch
    from nersemble_tpu_torch.ops import launch_counts
    from nersemble_tpu_torch.scripts import bench_quad_build, gather_probe, profile_step

    launch_counts.reset()
    for module, argv in ((bench_quad_build, ["--diag"]), (bench_quad_build, []),
                         (gather_probe, ["--rows", str(2 ** 18)]),
                         (profile_step, ["--iters", "3"])):
        command = " ".join(["python -m", module.__name__, *argv])
        start = time.perf_counter()
        log("diagnostics", f"$ {command}")
        module.main(argv)
        torch.cuda.empty_cache()
        log("diagnostics", f"{command}: {time.perf_counter() - start:.1f} s")
    launches = launch_counts.read(launch_counts.COPIES)
    log("diagnostics", f"launches {launches}")
    for kernel, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the measurement path never launched {kernel}")
    return launches


def seq_expected_keys(step: int, first: int, last: int) -> set:
    """The metrics.jsonl keys of ``step`` in a run of steps [first, last]
    with SEQ_ARGS' cadences (a budget change may add sample_budget)."""
    keys = set(SEQ_PARAM_KEYS) if step == first else set()
    if step % SEQ_CADENCE["log"] == 0 or step == last:
        keys |= SEQ_LOG_KEYS
    if step > 0 and step % SEQ_CADENCE["eval_batch"] == 0:
        keys |= {"eval_psnr", "eval_mse"}
    if step > 0 and step % SEQ_CADENCE["eval_image"] == 0:
        keys |= SEQ_EVAL_IMAGE_KEYS
    if step > 0 and step % SEQ_CADENCE["eval_all"] == 0:
        keys |= SEQ_EVAL_ALL_KEYS
    if step == last:
        keys.add("checkpoint_save_seconds")
    return keys


class SeqMonitor:
    """The train CLI's step hook: records the run's first step, config and
    budget per step, times each eval kind and the checkpoint saves (with a
    synchronize before, outside the quiet window), and runs the quiet steps
    under torch.cuda.set_sync_debug_mode("error") between two synchronizes."""

    def __init__(self, quiet=SEQ_QUIET, evals=SEQ_EVALS):
        self.quiet, self.evals = quiet, evals
        self.trainer = None
        self.first_step = self.start_budget = None
        self.budgets = {}
        self.seconds = collections.defaultdict(list)
        self.quiet_ms = None
        self.batch_wait = None

    def _timed(self, name, fn):
        import torch

        def run(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name].append(time.perf_counter() - start)
            return out
        return run

    def __call__(self, trainer, step: int, phase: str) -> None:
        import torch
        from nersemble_tpu_torch.utils import spans
        if self.trainer is None:
            self.trainer, self.first_step = trainer, step
            self.start_budget = trainer._budget
            for name in self.evals:
                setattr(trainer, name, self._timed(name, getattr(trainer, name)))
        if phase == "begin":
            self.budgets[step] = trainer._budget
        if phase == "begin" and step == self.quiet[0]:
            torch.cuda.synchronize()
            self._quiet = (time.perf_counter(), spans.counter("batch_wait_s"),
                           spans.counter("batch_copy_s"))
            torch.cuda.set_sync_debug_mode("error")
        if phase == "end" and step == self.quiet[1]:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            start, wait_s, copy_s = self._quiet
            n = self.quiet[1] - self.quiet[0] + 1
            self.quiet_ms = (time.perf_counter() - start) * 1e3 / n
            self.batch_wait = (spans.counter("batch_wait_s") - wait_s,
                               spans.counter("batch_copy_s") - copy_s)


def read_metrics(path) -> dict:
    """metrics.jsonl -> {step: {key: value}} (a step's records merged)."""
    steps = collections.defaultdict(dict)
    for line in path.read_text().splitlines():
        record = json.loads(line)
        steps[record.pop("step")].update(record)
    return steps


def sequence_phase(train_step_ms: float) -> dict:
    """The sequence-training path through the train CLI (phase 12), then
    phases 13 and 14 on its capture; returns phase 14's launches."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    from nersemble_tpu_torch import env
    from nersemble_tpu_torch.config import TrainConfig
    from nersemble_tpu_torch.ops import launch_counts
    from nersemble_tpu_torch.scripts import train_nersemble
    from nersemble_tpu_torch.utils import spans
    from nersemble_tpu_torch.utils.synthetic_capture import write_capture

    root = Path(tempfile.mkdtemp(prefix="nersemble_sequence_"))
    saved_env = (env.NERSEMBLE_DATA_PATH, env.NERSEMBLE_MODELS_PATH)
    try:
        start = time.perf_counter()
        meta = write_capture(root / "data", SEQ_PARTICIPANT, SEQ_SEQUENCE,
                             n_timesteps=3, original_size=SEQ_ORIGINAL_SIZE)
        log("sequence", f"synthetic capture: 16 cameras x 3 timesteps at "
                        f"{meta['image_size'][0]}x{meta['image_size'][1]} written "
                        f"in {time.perf_counter() - start:.1f} s")
        env.NERSEMBLE_DATA_PATH = str(root / "data")
        env.NERSEMBLE_MODELS_PATH = str(root / "models")
        run_dir = root / "models" / "nersemble" / f"NERS-001-{SEQ_NAME}"

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launch_counts.reset()
        monitor = SeqMonitor()
        batch_s0 = spans.counter("batch_wait_s"), spans.counter("batch_copy_s")
        start = time.perf_counter()
        train_nersemble.main(SEQ_ARGS + ["--name", SEQ_NAME, "--max-num-iterations",
                                         str(SEQ_STEPS)], step_hook=monitor)
        run_s = time.perf_counter() - start
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = launch_counts.read()
        trainer = monitor.trainer
        metrics = read_metrics(run_dir / "metrics.jsonl")
        ckpts = sorted((run_dir / "checkpoints").glob("step-*.ckpt"))
        saved_config = TrainConfig.load(run_dir / "config.yml")
        config_equal = saved_config.to_dict() == trainer.train_config.to_dict()
        with np.load(ckpts[-1]) as ckpt:
            saved_budget = int(ckpt["extra/sample_budget"])
        budget_changes = [(s, b) for s, b in sorted(monitor.budgets.items())
                          if s > monitor.first_step and b != monitor.budgets[s - 1]]
        losses = [(s, m["train_loss"]) for s, m in sorted(metrics.items())
                  if "train_loss" in m]
        wait_s, copy_s = monitor.batch_wait
        log("sequence", f"{SEQ_STEPS} steps through the train CLI in {run_s:.1f} s: "
                        f"loop {monitor.quiet_ms:.1f} ms/step over steps "
                        f"{SEQ_QUIET[0]}-{SEQ_QUIET[1]} (no log, eval, save or "
                        f"device read; train phase {train_step_ms:.1f} ms/step "
                        f"through run_step at budget 73,728), batch wait "
                        f"{wait_s:.4f} s and copy {copy_s:.4f} s over those steps "
                        f"({spans.counter('batch_wait_s') - batch_s0[0]:.3f} s / "
                        f"{spans.counter('batch_copy_s') - batch_s0[1]:.3f} s over the run)")
        log("sequence", f"budget {monitor.start_budget} at step {monitor.first_step}, "
                        f"{trainer._budget} at the end, changes {budget_changes}; "
                        f"chunk cap {trainer.config.max_n_samples_per_batch}; "
                        f"peak memory {peak_gib:.2f} GiB; launches {launches}")
        for name in SEQ_EVALS:
            log("sequence", f"{name}: seconds {[round(x, 3) for x in monitor.seconds[name]]}")
        log("sequence", f"train_loss by logged step {[(s, round(v, 6)) for s, v in losses]}; "
                        f"eval_all psnr {metrics[48]['eval_all_psnr']:.3f} ssim "
                        f"{metrics[48]['eval_all_ssim']:.4f}; checkpoints "
                        f"{[p.name for p in ckpts]} ({ckpts[-1].stat().st_size / 2**30:.2f} "
                        f"GiB), config.yml reads back equal: {config_equal}")
        if not all(math.isfinite(v) for _, v in losses) or not losses[-1][1] < losses[0][1]:
            raise AssertionError(f"losses not finite or not falling: {losses}")
        psnr, ssim = metrics[48]["eval_all_psnr"], metrics[48]["eval_all_ssim"]
        if not (math.isfinite(psnr) and 0.0 <= ssim <= 1.0):
            raise AssertionError(f"eval_all psnr {psnr}, ssim {ssim}")
        for kernel, count in launches.items():
            if count <= 0:
                raise AssertionError(f"the sequence path never launched {kernel}")
        for step in range(SEQ_STEPS):
            keys = set(metrics.get(step, {})) - {"wall", "sample_budget"}
            want = seq_expected_keys(step, 0, SEQ_STEPS - 1)
            if keys != want:
                raise AssertionError(f"metrics.jsonl step {step}: missing "
                                     f"{sorted(want - keys)}, extra {sorted(keys - want)}")
        if [p.name for p in ckpts] != [f"step-{SEQ_STEPS - 1:09d}.ckpt"]:
            raise AssertionError(f"checkpoints {ckpts}")
        if not config_equal:
            raise AssertionError("config.yml does not read back equal")
        if monitor.quiet_ms is None:
            raise AssertionError("the quiet steps never ran")
        del trainer, monitor
        torch.cuda.empty_cache()

        launch_counts.reset()
        resumed = SeqMonitor()
        start = time.perf_counter()
        train_nersemble.main(SEQ_ARGS[:2] + ["--resume-run", f"NERS-001-{SEQ_NAME}",
                                             "--max-num-iterations", str(SEQ_RESUMED_STEPS)],
                             step_hook=resumed)
        metrics = read_metrics(run_dir / "metrics.jsonl")
        ckpts = sorted((run_dir / "checkpoints").glob("step-*.ckpt"))
        log("sequence", f"resumed at step {resumed.first_step} with budget "
                        f"{resumed.start_budget} (saved {saved_budget}) to step "
                        f"{SEQ_RESUMED_STEPS - 1} in {time.perf_counter() - start:.1f} s; "
                        f"checkpoint save {metrics[SEQ_STEPS - 1]['checkpoint_save_seconds']:.1f} s "
                        f"({resumed.seconds['save_run_checkpoint']}), load "
                        f"{resumed.trainer.checkpoint_load_s:.1f} s; train_loss "
                        f"{[(s, round(metrics[s]['train_loss'], 6)) for s in (50, 52)]}; "
                        f"checkpoints {[p.name for p in ckpts]}; launches "
                        f"{launch_counts.read()}")
        if resumed.first_step != SEQ_STEPS or resumed.start_budget != saved_budget:
            raise AssertionError(f"resumed at step {resumed.first_step} with budget "
                                 f"{resumed.start_budget}, saved {saved_budget}")
        for step in range(SEQ_STEPS, SEQ_RESUMED_STEPS):
            keys = set(metrics.get(step, {})) - {"wall", "sample_budget"}
            want = seq_expected_keys(step, SEQ_STEPS, SEQ_RESUMED_STEPS - 1)
            if keys != want:
                raise AssertionError(f"resumed metrics.jsonl step {step}: missing "
                                     f"{sorted(want - keys)}, extra {sorted(keys - want)}")
        if [p.name for p in ckpts] != [f"step-{SEQ_RESUMED_STEPS - 1:09d}.ckpt"]:
            raise AssertionError(f"checkpoints after the resume {ckpts}")
        del resumed

        # ---- 13. serve: the serving CLIs on this run ----------------------------
        serve_phase(root, f"NERS-001-{SEQ_NAME}")

        # ---- 14. variants: the model's other configurations -------------------
        return variants_phase(root, torch.device("cuda"))
    finally:
        env.NERSEMBLE_DATA_PATH, env.NERSEMBLE_MODELS_PATH = saved_env
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


class RenderLog:
    """Wraps NeRSembleTrainer.render_image while the serving CLIs run: each
    frame's milliseconds (it ends in the frame's copy to the host), the
    share of its rays that can hit an occupied cell, its B1-fwd, B3 and
    A3-fwd launches, the auto budget after it, and the synchronizing calls made
    inside it (torch.cuda.set_sync_debug_mode("warn")) by file:line. Keeps
    the last trainer it saw."""

    def __init__(self):
        self.frames = []
        self.trainer = None

    def __enter__(self):
        from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
        self._original = NeRSembleTrainer.render_image
        log = self

        def render_image(trainer, image_rays, step, chunk=None, budget=None):
            return log.record(trainer, image_rays, step, chunk, budget)

        NeRSembleTrainer.render_image = render_image
        return self

    def __exit__(self, *exc):
        from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
        NeRSembleTrainer.render_image = self._original

    def take(self):
        """The frames recorded since the last take."""
        frames, self.frames = self.frames, []
        return frames

    def record(self, trainer, image_rays, step, chunk, budget):
        import os

        import torch
        from nersemble_tpu_torch.ops import launch_counts

        self.trainer = trainer
        torch.cuda.synchronize()
        before = launch_counts.read(launch_counts.FORWARD)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            start = time.perf_counter()
            try:
                out = self._original(trainer, image_rays, step, chunk, budget)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            ms = (time.perf_counter() - start) * 1e3
        hit = trainer.renderer().render_hit_mask(
            torch.from_numpy(np.asarray(image_rays["origins"])).to(trainer.device),
            torch.from_numpy(np.asarray(image_rays["directions"])).to(trainer.device))
        self.frames.append({
            "ms": ms, "hit": float(hit.float().mean()),
            **{FRAME_KEYS[k]: n - before[k]
               for k, n in launch_counts.read(launch_counts.FORWARD).items()},
            "budget": trainer.renderer().auto_budget,
            "syncs": [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                      if "called a synchronizing" in str(w.message)]})
        return out


def summarize_frames(phase: str, what: str, frames) -> dict:
    """Print a CLI's frames (ms, hit fraction, launches, syncs) and check
    that a frame waited on the device only where SERVE_SYNC_FILES allow and
    that hitting frames launched the three forward kernels; returns the
    totals."""
    ms = [f["ms"] for f in frames]
    syncs = collections.Counter(s for f in frames for s in f["syncs"])
    totals = {"frames": len(frames),
              **{k: sum(f[k] for f in frames) for k in FRAME_KEYS.values()},
              "hit": max((f["hit"] for f in frames), default=0.0)}
    log(phase, f"{len(frames)} {what}: ms {[round(x, 1) for x in ms]} "
               f"(mean {sum(ms) / max(len(ms), 1):.1f}); hit fraction "
               f"{[round(f['hit'], 4) for f in frames]}; B1-fwd launches "
               f"{[f['fwd'] for f in frames]}, B3 {[f['build'] for f in frames]}, "
               f"A3-fwd {[f['encode'] for f in frames]}; "
               f"host waits per frame {[len(f['syncs']) for f in frames]} at "
               f"{dict(syncs)}")
    stray = [s for s in syncs if s.split(":")[0] not in SERVE_SYNC_FILES]
    if stray:
        raise AssertionError(f"{what}: synchronizing calls outside the renderer's "
                             f"reads: {stray}")
    if totals["hit"] > 0 and min(totals[k] for k in FRAME_KEYS.values()) <= 0:
        raise AssertionError(f"{what} hit the grid but launched B1-fwd "
                             f"{totals['fwd']} / B3 {totals['build']} / A3-fwd "
                             f"{totals['encode']} times")
    return totals


def synthetic_vgg_weights(seed: int) -> dict:
    """Random VGG-16-shaped conv weights and LPIPS heads (small scale so
    the activations stay finite): what LPIPS computes on, not a trained
    network."""
    rng = np.random.default_rng(seed)
    convs = {0: (64, 3), 2: (64, 64), 5: (128, 64), 7: (128, 128),
             10: (256, 128), 12: (256, 256), 14: (256, 256), 17: (512, 256),
             19: (512, 512), 21: (512, 512), 24: (512, 512), 26: (512, 512),
             28: (512, 512)}
    weights = {}
    for i, (o, c) in convs.items():
        weights[f"features.{i}.weight"] = rng.normal(0, 0.05, (o, c, 3, 3)).astype(np.float32)
        weights[f"features.{i}.bias"] = rng.normal(0, 0.01, (o,)).astype(np.float32)
    for k, c in enumerate((64, 128, 256, 512, 512)):
        weights[f"lin{k}.model.1.weight"] = rng.uniform(0, 0.1, (1, c, 1, 1)).astype(np.float32)
    return weights


def view_client(port: int, replies: dict) -> None:
    """The viewer's browser: one request per channel at SERVE_VIEW_WIDTH,
    each waiting for the CLI's server to come up."""
    import urllib.error
    import urllib.request

    for channel in SERVE_CHANNELS:
        url = (f"http://127.0.0.1:{port}/render?channel={channel}"
               f"&width={SERVE_VIEW_WIDTH}&az=0.6&el=0.2&t=0.5")
        deadline = time.time() + 300
        while True:
            start = time.perf_counter()
            try:
                with urllib.request.urlopen(url, timeout=300) as reply:
                    replies[channel] = (reply.status, reply.read(),
                                        1e3 * (time.perf_counter() - start))
                break
            except urllib.error.URLError:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)


def auto_vs_none(trainer, rays, step: int, grid: str, hold: bool) -> None:
    """Render ``rays`` with budget=None, then "auto" (its probe, then, when
    ``hold``, with the cached budget), print ms, peak memory and the probed
    budget, and (``hold``) hold every auto render to the None one within
    REF_TOL."""
    import torch

    renderer = trainer.renderer()
    renderer.auto_budget = None
    kinds = [("none", None), ("auto probe", "auto")] + ([("auto cached", "auto")] if hold else [])
    times, images = {}, {}
    for kind, budget in kinds:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        images[kind] = trainer.render_image(rays, step, chunk=CHUNK, budget=budget)
        times[kind] = (round((time.perf_counter() - start) * 1e3, 1),
                       round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
    scfg = trainer.config.sampling
    default = -(-int(CHUNK * scfg.max_samples_per_ray * scfg.global_budget_fraction) // 128) * 128
    errs = {key: float(np.abs(images["auto probe"][key] - images["none"][key]).max())
            for key in images["none"]}
    log("serve", f"eval view {rays['width']}x{rays['height']} on {grid}, chunk {CHUNK}: "
                 f"ms and peak GiB {times}; probed budget {renderer.auto_budget} "
                 f"(budget=None: {default} per chunk); auto vs None max abs diff {errs}"
                 + (f" (tol {REF_TOL})" if hold else " (not held)"))
    if hold:
        # a budget no larger than the default, grown over every chunk that
        # overflowed, means no chunk had more valid samples than the
        # default budget holds: None dropped none, and auto must equal it
        if not renderer.auto_budget <= default:
            raise AssertionError(f"{grid}: probed budget {renderer.auto_budget} > "
                                 f"{default}: budget=None drops samples here")
        for kind in images:
            for key in images["none"]:
                np.testing.assert_allclose(images[kind][key], images["none"][key],
                                           **REF_TOL, err_msg=f"{kind} {key}")


def fresh_memory(phase: str) -> None:
    """Free what earlier work left (cycles included), print what stays
    allocated and start a new peak."""
    import gc

    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(phase, f"device memory allocated before the next CLI "
               f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")


def serve_phase(root, run_name: str) -> None:
    """The evaluate, render and view CLIs on phase 12's run (phase 13)."""
    import os
    import socket
    import threading
    from pathlib import Path

    import torch
    from nersemble_tpu_torch.ops import launch_counts
    from nersemble_tpu_torch.scripts import (
        evaluate_nersemble,
        render_nersemble,
        view_nersemble,
    )
    from nersemble_tpu_torch.utils import lpips, png

    run_dir = root / "models" / "nersemble" / run_name
    weights = root / "synthetic_vgg16.npz"
    np.savez(weights, **synthetic_vgg_weights(SEED))
    saved_lpips = os.environ.get("NERSEMBLE_LPIPS_WEIGHTS")
    os.environ["NERSEMBLE_LPIPS_WEIGHTS"] = str(weights)
    lpips.reset_lpips_cache()
    launch_counts.reset()
    try:
        with RenderLog() as renders:
            # (a) evaluate, with the occupancy filter, LPIPS and the vendored JOD
            fresh_memory("serve")
            start = time.perf_counter()
            result = evaluate_nersemble.main([run_name] + SERVE_EVAL_ARGS)
            eval_s = time.perf_counter() - start
            eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            trainer = renders.trainer
            evals = summarize_frames("serve", "eval images", renders.take())
            pngs = sorted((run_dir / "evaluation").rglob("cam_*.png"))
            mean = result.mean
            log("serve", f"evaluate: {eval_s:.1f} s with set-up (checkpoint load "
                         f"{trainer.checkpoint_load_s:.1f} s), peak memory "
                         f"{eval_peak:.2f} GiB; {len(pngs)} PNGs; psnr "
                         f"{mean.regular.psnr:.3f} / masked {mean.masked.psnr:.3f}, "
                         f"ssim {mean.regular.ssim:.4f}, lpips {mean.regular.lpips}, "
                         f"jod {mean.regular.jod} / masked {mean.masked.jod}; grid "
                         f"cells after the filter "
                         f"{int(trainer.model.binaries(trainer.grid_occs, trainer.grid_mask).sum())}")
            if len(pngs) != 12:
                raise AssertionError(f"the evaluate CLI wrote {len(pngs)} PNGs, not 12")
            for bundle in (mean.regular, mean.masked):
                if not (math.isfinite(bundle.psnr) and 0.0 <= bundle.ssim <= 1.0
                        and bundle.jod is not None and math.isfinite(bundle.jod)
                        and bundle.lpips is not None and math.isfinite(bundle.lpips)):
                    raise AssertionError(f"evaluation metrics {bundle}")
            rays = trainer.eval_loader.image_rays(0)
            entry = rays["entry"]
            pred = png.imread(pngs[0].parent.parent / f"frame_{entry.original_timestep:05d}"
                              / f"cam_{entry.cam_id}.png").astype(np.float32) / 255
            start = time.perf_counter()
            on_card = lpips.lpips_or_none(pred, rays["gt_rgb"], "cuda")
            card_s = time.perf_counter() - start
            start = time.perf_counter()
            on_cpu = lpips.lpips_or_none(pred, rays["gt_rgb"], "cpu")
            cpu_s = time.perf_counter() - start
            rel = abs(on_card - on_cpu) / abs(on_cpu)
            log("serve", f"LPIPS of cam {entry.cam_id} frame {entry.original_timestep} "
                         f"{pred.shape}: card {on_card:.8f} ({card_s:.2f} s with the "
                         f"weights' copy), CPU {on_cpu:.8f} ({cpu_s:.2f} s), rel err "
                         f"{rel:.2e} (tol {LPIPS_RTOL:g})")
            if not rel <= LPIPS_RTOL:
                raise AssertionError(f"LPIPS on the card {on_card} vs CPU {on_cpu}")
            del trainer, rays
            renders.trainer = None
            if evals["hit"] == 0:
                # the filter kept no cell (a run still in its occupancy
                # warm-up): the CLI again without it, so that its frames hit
                fresh_memory("serve")
                start = time.perf_counter()
                evaluate_nersemble.main([run_name, "--max-eval-timesteps", "1",
                                         "--n-rays-eval", str(CHUNK),
                                         "--no-use-occupancy-grid-filtering"])
                log("serve", f"evaluate without the filter: "
                             f"{time.perf_counter() - start:.1f} s with set-up, peak "
                             f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
                unfiltered = summarize_frames("serve", "eval images without the filter",
                                              renders.take())
                renders.trainer = None
                if unfiltered["hit"] == 0:
                    raise AssertionError("no eval image hits the grid without the filter")
                evals = unfiltered

            # (b) the render CLI's orbit video
            fresh_memory("serve")
            start = time.perf_counter()
            outputs = render_nersemble.main([run_name] + SERVE_RENDER_ARGS,
                                            renders_path=str(root / "renders"))
            render_s = time.perf_counter() - start
            render_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            video = summarize_frames("serve", "video frames", renders.take())
            shapes = {channel: sorted({png.imread(f).shape for f in Path(path).iterdir()})
                      for channel, path in outputs.items()}
            counts = {channel: len(list(Path(path).iterdir()))
                      for channel, path in outputs.items()}
            log("serve", f"render: {render_s:.1f} s with set-up, peak memory "
                         f"{render_peak:.2f} GiB; frames {counts}, shapes {shapes}")
            renders.trainer = None
            if set(outputs) != set(SERVE_CHANNELS) or set(counts.values()) != {8} \
                    or any(s != [(FRAME_H, FRAME_W, 3)] for s in shapes.values()):
                raise AssertionError(f"render CLI outputs {counts} {shapes}")

            # (c) the view CLI, three requests from a thread
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            replies = {}
            client = threading.Thread(target=view_client, args=(port, replies),
                                      daemon=True)
            fresh_memory("serve")
            client.start()
            served = view_nersemble.main([run_name, "--port", str(port)], max_requests=3)
            client.join(timeout=60)
            view_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            trainer = renders.trainer
            requests = renders.take()
            view = summarize_frames("serve", "viewer requests", requests)
            decoded = {}
            for channel, (status, body, _) in replies.items():
                decoded[channel] = png.decode(body) if status == 200 else None
            log("serve", f"view: {served} requests served, round trips "
                         f"{ {c: round(r[2], 1) for c, r in replies.items()} } ms, "
                         f"frames {({c: None if d is None else d.shape for c, d in decoded.items()})}, "
                         f"auto budget per request {[f['budget'] for f in requests]}, "
                         f"peak memory {view_peak:.2f} GiB")
            if served != 3 or client.is_alive() or set(decoded) != set(SERVE_CHANNELS):
                raise AssertionError(f"the viewer served {served}: {sorted(replies)}")
            for channel, frame in decoded.items():
                if frame is None or frame.ndim != 3 or frame.shape[1:] != (SERVE_VIEW_WIDTH, 3):
                    raise AssertionError(f"viewer {channel} reply {replies[channel][:1]}")
            if not requests[0]["hit"] > 0:
                raise AssertionError("the viewer's rgb frame hits no occupied cell")

        # (d) one eval view: budget="auto" (probe, then cached) vs None, on the
        # run's warm-up grid, where the default budget drops samples that
        # the probed budget keeps, and on a sparse grid with a carved
        # scene's few samples per ray, where it drops none and the two must
        # agree
        step = trainer.start_step - 1
        rays = trainer.eval_loader.image_rays(0)
        auto_vs_none(trainer, rays, step, "the run's grid", hold=False)
        g = trainer.config.grid_resolution
        sparse = np.random.default_rng(SEED).uniform(size=g ** 3) < SERVE_SPARSE_FILL
        trainer.grid_occs = torch.from_numpy(sparse.astype(np.float32)).to(trainer.device)
        trainer._renderer = None
        auto_vs_none(trainer, rays, step, f"a {SERVE_SPARSE_FILL:.1%} random grid", hold=True)
        del trainer, rays
        launches = launch_counts.read(launch_counts.FORWARD)
        log("serve", f"launches in the phase {launches}; per eval image B1-fwd "
                     f"{evals['fwd'] / max(evals['frames'], 1):.1f} / B3 "
                     f"{evals['build'] / max(evals['frames'], 1):.2f}, per video frame "
                     f"{video['fwd'] / max(video['frames'], 1):.1f} / "
                     f"{video['build'] / max(video['frames'], 1):.2f}, per viewer request "
                     f"{view['fwd'] / max(view['frames'], 1):.1f} / "
                     f"{view['build'] / max(view['frames'], 1):.2f}")
        for kernel, count in launches.items():
            if count <= 0:
                raise AssertionError(f"the serving path never launched {kernel}")
    finally:
        if saved_lpips is None:
            os.environ.pop("NERSEMBLE_LPIPS_WEIGHTS", None)
        else:
            os.environ["NERSEMBLE_LPIPS_WEIGHTS"] = saved_lpips
        lpips.reset_lpips_cache()
        torch.cuda.empty_cache()


def variant_run(what: str, monitor, run_dir, steps: int, run_s: float) -> list:
    """Print a variant run (quiet ms/step, eval and save seconds, peak
    memory, budget, launches, logged losses) and hold it: losses finite, the
    six train-path kernels launched, an eval image rendered, one
    checkpoint at the last step. Returns the logged losses and the
    launches."""
    import torch
    from nersemble_tpu_torch.scripts.trained_scene import launches as train_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = train_launches()
    metrics = read_metrics(run_dir / "metrics.jsonl")
    losses = [(s, m["train_loss"]) for s, m in sorted(metrics.items())
              if "train_loss" in m]
    ckpts = sorted((run_dir / "checkpoints").glob("step-*.ckpt"))
    trainer = monitor.trainer
    log("variants", f"({what}) {steps} steps in {run_s:.1f} s: loop "
                    f"{monitor.quiet_ms:.1f} ms/step over steps {monitor.quiet[0]}-"
                    f"{monitor.quiet[1]}; eval image s "
                    f"{[round(x, 3) for x in monitor.seconds['_eval_image']]}, train image s "
                    f"{[round(x, 3) for x in monitor.seconds['_train_image']]}, save s "
                    f"{[round(x, 3) for x in monitor.seconds['save_run_checkpoint']]}; "
                    f"peak memory {peak_gib:.2f} GiB; table "
                    f"{tuple(trainer.params.field.table.shape)}, candidates "
                    f"{trainer.config.sampling.max_candidates_per_ray}, budget "
                    f"{monitor.start_budget} -> {trainer._budget}; launches {launches}; "
                    f"train_loss {[(s, round(v, 6)) for s, v in losses]}; checkpoints "
                    f"{[p.name for p in ckpts]}")
    if not losses or not all(math.isfinite(v) for _, v in losses):
        raise AssertionError(f"({what}) losses not finite: {losses}")
    for kernel in TRAIN_KERNELS:
        if launches[kernel] <= 0:
            raise AssertionError(f"({what}) never launched {kernel}")
    if not monitor.seconds["_eval_image"] or monitor.quiet_ms is None:
        raise AssertionError(f"({what}) no eval image or no quiet steps")
    if [p.name for p in ckpts] != [f"step-{steps - 1:09d}.ckpt"]:
        raise AssertionError(f"({what}) checkpoints {ckpts}")
    return losses, launches


def variants_phase(root, device) -> dict:
    """The model's other configurations (phase 14): (a) and (b) on phase
    12's capture under ``root``, then (c) the tiny variants, GPU vs CPU.
    Returns the train-path kernels' launches in (a) and (b)."""
    from pathlib import Path

    import torch
    import torch.nn.functional as F
    from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
    from nersemble_tpu_torch.model_manager import NeRSembleModelFolder
    from nersemble_tpu_torch.models import nersemble
    from nersemble_tpu_torch.ops import fused_mlp
    from nersemble_tpu_torch.scripts import (
        evaluate_nersemble,
        render_nersemble,
        train_nersemble,
    )
    from nersemble_tpu_torch.scripts.trained_scene import launches as train_launches
    from nersemble_tpu_torch.scripts.trained_scene import reset_launches
    from nersemble_tpu_torch.utils import png
    from nersemble_tpu_torch.utils.timing import cuda_time_ms

    # count the two-phase prefilter's entry passes (eval marches only)
    entry_calls = [0]
    original_entry = nersemble.coarse_entry_steps

    def counted_entry(*args, **kwargs):
        entry_calls[0] += 1
        return original_entry(*args, **kwargs)

    nersemble.coarse_entry_steps = counted_entry
    try:
        # (a) the train CLI: single grid, cone angle, early stop
        fresh_memory("variants")
        reset_launches()
        monitor = SeqMonitor(VAR_A_QUIET, VAR_EVALS)
        start = time.perf_counter()
        train_nersemble.main(SEQ_ARGS[:2] + VAR_A_FLAGS + [
            "--name", VAR_A_NAME, "--max-num-iterations", str(VAR_A_STEPS)],
            step_hook=monitor)
        run_dir = monitor.trainer.run_dir
        run_name = run_dir.name
        losses, launches_a = variant_run(
            "a: single grid, cone 0.004, early stop 1e-4", monitor, run_dir,
            VAR_A_STEPS, time.perf_counter() - start)
        cfg = monitor.trainer.config
        log("variants", f"(a) cone angle {cfg.cone_angle}, early_stop_eps "
                        f"{cfg.early_stop_eps}, {cfg.grid_levels} grid level(s): "
                        f"{cfg.sampling.max_candidates_per_ray} candidates against "
                        f"{cfg.sampling.eval_fine_candidates} fine ones, two-phase entry "
                        f"passes {entry_calls[0]}")
        if not losses[-1][1] < losses[0][1]:
            raise AssertionError(f"(a) the loss did not fall: {losses}")
        launches = train_launches()
        if not (launches["quad_build narrow"] == launches["quad_build"]
                and launches["quad_fold narrow"] == launches["quad_fold"]):
            raise AssertionError(f"(a) B3/B4 ran on rows that are not narrow: {launches}")
        del monitor, cfg

        with RenderLog() as renders:
            fresh_memory("variants")
            start = time.perf_counter()
            result = evaluate_nersemble.main([run_name, "--max-eval-timesteps", "1",
                                              "--n-rays-eval", str(CHUNK),
                                              "--no-use-occupancy-grid-filtering"])
            eval_s = time.perf_counter() - start
            evals = summarize_frames("variants", "(a) eval images", renders.take())
            pngs = sorted((run_dir / "evaluation").rglob("cam_*.png"))
            log("variants", f"(a) evaluate: {eval_s:.1f} s with set-up, peak memory "
                            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
                            f"{len(pngs)} PNGs; psnr {result.mean.regular.psnr:.3f}, "
                            f"ssim {result.mean.regular.ssim:.4f}")
            renders.trainer = None
            if len(pngs) != 4 or evals["hit"] == 0 or not (
                    math.isfinite(result.mean.regular.psnr)
                    and 0.0 <= result.mean.regular.ssim <= 1.0):
                raise AssertionError(f"(a) evaluate: {len(pngs)} PNGs, hit "
                                     f"{evals['hit']}, {result.mean.regular}")
            fresh_memory("variants")
            start = time.perf_counter()
            outputs = render_nersemble.main(
                [run_name, "--seconds", "1", "--fps", "2", "--downscale-factor", "2",
                 "--n-rays", str(CHUNK)], renders_path=str(root / "renders"))
            video = summarize_frames("variants", "(a) video frames", renders.take())
            shapes = [png.imread(f).shape for f in sorted(Path(outputs["rgb"]).iterdir())]
            log("variants", f"(a) render: {time.perf_counter() - start:.1f} s with "
                            f"set-up; frames {shapes}")
            renders.trainer = None
            if video["frames"] != 2 or shapes != [(FRAME_H, FRAME_W, 3)] * 2:
                raise AssertionError(f"(a) render CLI frames {shapes}")

        # (b) the flagship with SH degree 4 and the appearance embedding
        fresh_memory("variants")
        reset_launches()
        fused_mlp.ROWS = collections.Counter()
        folder = NeRSembleModelFolder()
        manager = folder.new_run(name=VAR_B_NAME)
        args = train_nersemble.build_parser().parse_args(
            SEQ_ARGS[:2] + VAR_B_FLAGS + ["--max-num-iterations", str(VAR_B_STEPS)])
        config = train_nersemble.build_config(args, manager.get_run_name(),
                                              folder.get_location())
        config.model.spherical_harmonics_degree = 4
        config.model.use_appearance_embedding = True
        start = time.perf_counter()
        trainer = NeRSembleTrainer.from_train_config(config, model_manager=manager)
        manager.save_config(config)
        monitor = SeqMonitor(VAR_B_QUIET, VAR_EVALS)
        trainer.step_hook = monitor
        try:
            trainer.train()
        finally:
            trainer.writer.close()
        rows, fused_mlp.ROWS = fused_mlp.ROWS, None
        _, launches_b = variant_run(
            "b: flagship, SH 4 + appearance", monitor, Path(manager.get_location()),
            VAR_B_STEPS, time.perf_counter() - start)
        heads = {key: n for key, n in rows.items() if key[:2] == (63, 3)}
        log("variants", f"(b) B1-fwd head launches at d_in 63: {sum(heads.values())} "
                        f"over {sum(r * n for (_, _, r), n in heads.items())} rows; "
                        f"appearance embedding "
                        f"{tuple(trainer.params.field.appearance_embedding.shape)}")
        if not heads:
            raise AssertionError(f"(b) no head launch at d_in 63: {sorted(rows)[:8]}")
        # the appearance gather's backward at the step's sample count: an
        # embedding backward (segments summed in parallel), not the indexing
        # backward the time codes take (one warp per run of an index)
        emb = trainer.params.field.appearance_embedding.detach().clone().requires_grad_(True)
        gen = torch.Generator(device=device).manual_seed(SEED)
        n_rows = trainer._budget
        cams = torch.randint(0, emb.shape[0], (n_rows,), generator=gen, device=device)
        grad = torch.randn(n_rows, emb.shape[1], generator=gen, device=device)
        timesteps = torch.randint(0, trainer.config.n_timesteps, (n_rows,),
                                  generator=gen, device=device)
        codes = trainer.params.time_embedding.detach().clone().requires_grad_(True)
        code_grad = torch.randn(n_rows, codes.shape[1], generator=gen, device=device)
        appearance_ms = cuda_time_ms(lambda: torch.autograd.grad(
            F.embedding(cams, emb), emb, grad))
        indexing_ms = cuda_time_ms(lambda: torch.autograd.grad(emb[cams], emb, grad))
        codes_ms = cuda_time_ms(lambda: torch.autograd.grad(
            codes[timesteps], codes, code_grad))
        log("variants", f"(b) appearance gather backward at {n_rows} rows over "
                        f"{emb.shape[0]} images: {appearance_ms:.4f} ms as an embedding "
                        f"(the port's), {indexing_ms:.4f} ms by indexing; the time "
                        f"codes' indexing backward over {codes.shape[0]} timesteps "
                        f"{codes_ms:.4f} ms")
        del trainer, monitor, emb, cams, grad, codes, code_grad, timesteps
        torch.cuda.empty_cache()
    finally:
        nersemble.coarse_entry_steps = original_entry
        fused_mlp.ROWS = None

    # (c) every configuration of tests/test_torch_variants.py: a tiny train
    # step and a small frame on the GPU vs the port's CPU path
    entry_calls[0] = 0
    nersemble.coarse_entry_steps = counted_entry
    try:
        for variant in TINY_VARIANTS:
            reset_launches()
            train_reference_phase(device, variant, phase=f"variants (c) {variant}")
            frame_reference(device, variant, phase=f"variants (c) {variant}")
            launches = train_launches()
            if min(launches[k] for k in TRAIN_KERNELS) <= 0:
                raise AssertionError(f"(c) {variant}: launches {launches}")
            if variant.startswith("single_grid") and launches["quad_build narrow"] <= 0:
                raise AssertionError(f"(c) {variant}: no narrow B3 launch")
    finally:
        nersemble.coarse_entry_steps = original_entry
    log("variants", f"(c) two-phase entry passes over the tiny variants {entry_calls[0]}")
    if entry_calls[0] <= 0:
        raise AssertionError("(c) the cone variant's frame never took the two-phase "
                             "prefilter")
    return {"a": launches_a, "b": launches_b}


def parallel_phase() -> dict:
    """The multi-device layouts (phase 16): (a) one NCCL rank vs the plain
    trainer, (b) ZeRO-3 over two gloo ranks on this card vs one rank, (c)
    with two or more cards visible, ZeRO-3 over NCCL on all of them vs one
    rank and bench_projection. Returns the kernels' launches in (a)'s rank
    and (b)'s rank 0 (and (c)'s). The runs' parameters (~1.7 GB each) go
    through a temporary directory."""
    import shutil
    import tempfile
    from pathlib import Path

    out_dir = Path(tempfile.mkdtemp(prefix="nersemble_parallel_"))
    try:
        return _parallel_runs(out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def flagship_steps_spec() -> dict:
    """The flagship's steps PAR_FIRST_STEP.. (PAR_STEPS of them) as a
    ``parallel/compare.run_steps`` spec: seeded weights scaled by
    ``add_contrast``, bench.py's grid, 4096 rays of
    ``compare.synthetic_batches``, the steady-state budget, the schedule's
    end, constant learning rates; a sampled occupancy update and a budget
    decision at step 80000. PyTorch's deterministic algorithms stay off."""
    from nersemble_tpu_torch.bench import LRS
    from nersemble_tpu_torch.config import flagship_model_config
    from nersemble_tpu_torch.ops.sampling import quantized_budget
    from nersemble_tpu_torch.parallel import compare
    from nersemble_tpu_torch.utils.bench_data import STEADY_STATE_FILL, bench_grid
    from nersemble_tpu_torch.utils.windows import sched_values

    cfg = flagship_model_config(tiny=False)
    S = cfg.sampling.max_samples_per_ray
    return {"config": cfg, "layout": "replicated", "params": None,
            "grid_occs": bench_grid(cfg.grid_resolution).numpy(),
            "batches": compare.synthetic_batches(TRAIN_RAYS, PAR_STEPS, cfg.n_timesteps,
                                                 seed=SEED),
            "first_step": PAR_FIRST_STEP, "lrs": LRS,
            "sched": sched_values(cfg, cfg.window_hash_encodings_end + 1),
            "budget": quantized_budget(STEADY_STATE_FILL, TRAIN_RAYS, S),
            "device": "cuda", "contrast": True}


def repeat_phase() -> None:
    """ROADMAP C11 at default settings (phase 6b): the flagship's three
    steps of ``flagship_steps_spec`` twice from the same seed and batches,
    and once saved after the first step and resumed in a fresh trainer for
    the other two; the parameters and first moments of all three end equal,
    bit for bit (SHA-256)."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    from nersemble_tpu_torch.models.nersemble import NeRSembleModel
    from nersemble_tpu_torch.parallel import compare
    from nersemble_tpu_torch.utils.params import to_tree

    spec = flagship_steps_spec()
    # run_steps' own seeded draw, made once on the host for the four runs
    init = NeRSembleModel(spec["config"], "cpu").init_params(
        torch.Generator().manual_seed(compare.SEED))
    spec.update(digest=True, params=to_tree(init, lambda t: t.detach().numpy()))
    del init
    root = Path(tempfile.mkdtemp(prefix="nersemble_repeat_"))
    try:
        runs = []
        for what, run_spec in (
                ("run 1", spec), ("run 2", spec),
                ("saved after the first step", dict(spec, batches=spec["batches"][:1],
                                                    digest=False,
                                                    out=str(root / "step.ckpt"))),
                ("resumed", dict(spec, batches=spec["batches"][1:],
                                 load=str(root / "step.ckpt")))):
            torch.cuda.empty_cache()
            start = time.perf_counter()
            result = compare.run_steps(None, run_spec)
            runs.append(result)
            log("repeat", f"{what}: ms/step {[round(x, 1) for x in result['ms_per_step']]}, "
                          f"loss {[round(x, 6) for x in result['loss']]}, "
                          f"budget-dropped {result['num_budget_dropped']}; "
                          f"{time.perf_counter() - start:.1f} s with set-up; "
                          f"launches {result['launches']}")
            for kernel in ("blended_encode_fwd", "blended_encode_bwd"):
                if result["launches"][kernel] <= 0:
                    raise AssertionError(f"repeat {what}: {kernel} never launched")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    first, second, _, resumed = runs
    for what, other in (("a second run", second), ("the resumed run", resumed)):
        differ = [k for k, v in first["digest"].items() if other["digest"][k] != v]
        if differ:
            raise AssertionError(f"C11: {what} differs from the first in {differ}")
    if second["loss"] != first["loss"] or resumed["loss"] != first["loss"][1:]:
        raise AssertionError(f"C11: losses {first['loss']}, {second['loss']}, "
                             f"resumed {resumed['loss']}")
    log("repeat", f"C11: two runs and a run resumed after step {PAR_FIRST_STEP}: "
                  f"losses and {len(first['digest'])} parameter and moment leaves "
                  f"bit for bit (SHA-256), PyTorch's deterministic algorithms off")


def _parallel_runs(out_dir) -> dict:
    import torch
    from nersemble_tpu_torch.parallel import compare, launch

    spec = flagship_steps_spec()
    cfg = spec["config"]
    S = cfg.sampling.max_samples_per_ray
    log("parallel", f"flagship {TRAIN_RAYS} rays, S={S}, budget {spec['budget']}, "
                    f"steps {PAR_FIRST_STEP}-{PAR_FIRST_STEP + PAR_STEPS - 1}; "
                    f"{torch.cuda.device_count()} card(s) visible")

    def load(name):
        with np.load(out_dir / f"{name}.npz") as data:
            return {k: data[k] for k in data.files}

    def plain(what, run_spec):
        """``run_steps`` in this process."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        result = compare.run_steps(None, run_spec)
        report(what, result)
        return result

    def ranks(what, n, backend, run_specs):
        """``run_steps`` of each spec on n new ranks."""
        torch.cuda.empty_cache()
        results = launch.spawn(compare.run_many, n, backend, "cuda",
                               [("run_steps", run_spec) for run_spec in run_specs])
        for run_spec, result in zip(run_specs, results):
            report(f"{what}, {run_spec['layout']}", result)
            if result["layout"] != run_spec["layout"] or not result["replicas_equal"]:
                raise AssertionError(f"{what}: layout {result['layout']}, replicas "
                                     f"equal {result['replicas_equal']}")
        if n > 1:
            log("parallel", f"{what}: every run's replicated parameters and grids "
                            f"equal on all ranks, bit for bit")
        return results

    def report(what, result):
        log("parallel", f"{what}: layout {result['layout']}, ms/step "
                        f"{[round(x, 1) for x in result['ms_per_step']]}, collectives' "
                        f"host ms {[round(x, 1) for x in result['comm_ms_per_step']]}, "
                        f"peak {[round(x, 2) for x in result.get('peak_gib', [])]} GiB "
                        f"per rank, loss {[round(x, 6) for x in result['loss']]}, "
                        f"budget-dropped {result['num_budget_dropped']}, launches "
                        f"{result['launches']}")
        if not all(math.isfinite(x) for x in result["loss"]):
            raise AssertionError(f"{what}: non-finite loss {result['loss']}")

    def out(name):
        return {"params_out": str(out_dir / f"{name}.npz")}

    def held(what, got, ref, hold=True):
        """Every parameter within PAR_TOL of ``ref`` (``hold`` False: only
        count the ones outside)."""
        worst, outside = (None, 0.0), 0
        for key, value in ref.items():
            p_got, p_ref = got[key].astype(np.float64), value.astype(np.float64)
            ratio = np.abs(p_got - p_ref) / (PAR_TOL["atol"] + PAR_TOL["rtol"] * np.abs(p_ref))
            outside += int((ratio > 1).sum())
            if ratio.max() > worst[1]:
                worst = (key, float(ratio.max()))
        log("parallel", f"{what}: {len(ref)} leaves, the worst {worst} of atol "
                        f"{PAR_TOL['atol']} rtol {PAR_TOL['rtol']}; {outside} outside")
        if hold and worst[1] > 1.0:
            raise AssertionError(f"{what}: {worst[0]} at {worst[1]:.3f} of the bound")

    def gradients(what, got, ref, bf16_leaves=PAR_BF16_GRADS):
        """The first moments after the first step within PAR_GRAD_TOL."""
        shares = {}
        for key, value in ref.items():
            leaf = key[len("mu."):]
            rtol, atol = PAR_GRAD_TOL["bfloat16" if leaf in bf16_leaves else "float32"]
            scale = float(np.abs(value).max())
            share = float((np.abs(got[key] - value) / (atol * scale + rtol * np.abs(value))
                           ).max()) if scale > 0 else 0.0
            shares[leaf] = round(share, 4)
        log("parallel", f"{what}: the first step's gradients, each leaf's worst share "
                        f"of its bound: {shares}")
        bad = {k: v for k, v in shares.items() if v > 1.0}
        if bad:
            raise AssertionError(f"{what}: gradients past their bound {bad}")

    # (a) one NCCL rank vs the plain trainer: digests
    a = dict(spec, digest=True)
    ref = plain("(a) plain trainer", a)
    (one,) = ranks("(a) one NCCL rank", 1, "nccl", [a])
    differ = [k for k, v in ref["digest"].items() if one["digest"][k] != v]
    if one["loss"] != ref["loss"] or differ:
        raise AssertionError(f"(a) the NCCL rank differs: losses {one['loss']} vs "
                             f"{ref['loss']}, leaves {differ}")
    log("parallel", f"(a) one NCCL rank vs the plain trainer: losses and "
                    f"{len(ref['digest'])} parameter and moment leaves bit for bit "
                    f"(SHA-256)")
    launches = {"a": one["launches"]}

    # (b) ZeRO-3 over two gloo ranks on this card: vs the replicated table
    # on as many ranks (the layout alone differs) and vs one rank, f32 table
    b_cfg = copy.deepcopy(cfg)
    b_cfg.table_dtype = "float32"
    b = dict(spec, config=b_cfg)
    plain("(b) one rank, f32 table", dict(b, first_mu_out=str(out_dir / "b_one_mu.npz"),
                                          **out("b_one")))
    zero3, _ = ranks("(b) two gloo ranks", 2, "gloo", [
        dict(b, layout="zero3", first_mu_out=str(out_dir / "b_zero3_mu.npz"),
             **out("b_zero3")),
        dict(b, layout="replicated", **out("b_rep"))])
    held("(b) ZeRO-3 vs the replicated table, two gloo ranks each, after "
         f"{PAR_STEPS} steps", load("b_zero3"), load("b_rep"))
    b_one_mu = load("b_one_mu")
    gradients("(b) ZeRO-3 on two gloo ranks vs one rank", load("b_zero3_mu"), b_one_mu)
    held(f"(b) for information, not held: ZeRO-3 on two gloo ranks vs one rank "
         f"after {PAR_STEPS} steps", load("b_zero3"), load("b_one"), hold=False)
    launches["b"] = zero3["launches"]
    for run, counts in launches.items():
        for kernel, count in counts.items():
            if count <= 0:
                raise AssertionError(f"({run}) the parallel path never launched {kernel}")

    # (d) the feature-sharded single grid over two gloo ranks on this card
    launches["d"] = _grid_tp_runs(spec, out_dir, plain, ranks, gradients, load, out)
    # (e) the viewer and the evaluate CLI over two gloo ranks on this card
    launches["e"] = _serve_ranks_runs(out_dir)
    # (f) a feature split that cuts logical tables, four gloo ranks on this card
    launches["f"] = _cut_tp_runs(spec, plain, ranks, gradients, load, out_dir)

    # (c) every visible card over NCCL
    n = torch.cuda.device_count()
    if n < 2:
        log("parallel", "(c) not run: one card visible (NCCL takes one card per "
                        "rank; bench_projection's n-rank step needs n cards)")
        return launches
    (many,) = ranks(f"(c) {n} NCCL ranks", n, "nccl",
                    [dict(b, layout="zero3", first_mu_out=str(out_dir / "c_mu.npz"))])
    gradients(f"(c) ZeRO-3 on {n} NCCL ranks vs one rank", load("c_mu"), b_one_mu)
    from nersemble_tpu_torch.scripts import bench_projection
    torch.cuda.empty_cache()
    projection = bench_projection.main(["--n-cards", str(n)])
    log("parallel", f"(c) bench_projection over {n} cards: {json.dumps(projection)}")
    launches["c"] = many["launches"]
    return launches


def _grid_tp_runs(spec, out_dir, plain, ranks, gradients, load, out) -> dict:
    """Phase 16 (d): the flagship steps on the single-grid field at the
    train CLI's defaults ([6,184,960, 2] bf16 table) in the feature-sharded
    layout over two gloo ranks sharing this card, each rank one column
    (B3 on 2-byte rows, B4 on 2-byte quarters, A3 on quad rows of 4
    elements), against one rank: the first step's gradients within
    PAR_GRAD_TOL (the table's at the bf16 bound: it passes the bf16 quad),
    whether the three steps end bit for bit (printed), and two runs bit
    for bit (SHA-256). Returns the run's launches, the narrow ones too."""
    d_cfg = copy.deepcopy(spec["config"])
    d_cfg.use_hash_ensemble, d_cfg.hash_ensemble = False, None
    d = dict(spec, config=d_cfg, layout="tp", digest=True)
    plain("(d) one rank, single grid", dict(d, first_mu_out=str(out_dir / "d_one_mu.npz"),
                                            **out("d_one")))
    first, second = ranks("(d) two gloo ranks, single grid", 2, "gloo", [
        dict(d, first_mu_out=str(out_dir / "d_tp_mu.npz"), **out("d_tp")), d])
    gradients("(d) the feature-sharded single grid on two gloo ranks vs one rank",
              load("d_tp_mu"), load("d_one_mu"), PAR_BF16_GRADS + ("field.table",))
    one, two = load("d_one"), load("d_tp")
    unequal = {k: int((one[k] != two[k]).sum()) for k in one if (one[k] != two[k]).any()}
    mu_one, mu_two = load("d_one_mu"), load("d_tp_mu")
    mu_unequal = [k for k in mu_one if not np.array_equal(mu_one[k], mu_two[k])]
    log("parallel", f"(d) two ranks vs one rank after {PAR_STEPS} steps: "
                    + ("bit for bit" if not unequal else f"unequal entries {unequal}")
                    + "; the first step's gradients "
                    + ("bit for bit" if not mu_unequal else f"unequal in {mu_unequal}"))
    differ = [k for k, v in first["digest"].items() if second["digest"][k] != v]
    if differ or first["loss"] != second["loss"]:
        raise AssertionError(f"(d) two runs differ: leaves {differ}, losses "
                             f"{first['loss']} vs {second['loss']}")
    combined = hashlib.sha256(json.dumps(sorted(first["digest"].items())).encode()).hexdigest()
    log("parallel", f"(d) two runs of two ranks: losses and {len(first['digest'])} "
                    f"leaves bit for bit (SHA-256 of the leaves' digests {combined}); "
                    f"narrow launches {first['narrow_launches']}")
    for kernel, count in first["narrow_launches"].items():
        if count <= 0:
            raise AssertionError(f"(d) no {kernel} launch")
    return {**first["launches"], **first["narrow_launches"]}


def _cut_tp_runs(spec, plain, ranks, gradients, load, out_dir) -> dict:
    """Phase 16 (f): the flagship steps with the flagship's levels and
    entries but 6 logical tables of 2 features ([6,537,216, 12] table, f32
    as in (b)), feature-sharded over four gloo ranks sharing this card:
    rank r holds columns 3r to 3r+2, so tables 1 and 4 are cut, and each
    rank pads its columns to a 4-column window (models/field.tp_window: B3
    and B4 at [E, 4], A3 at quad rows of 16 elements over 2 tables).
    Against one rank: the first step's gradients within PAR_GRAD_TOL, as
    (b) holds them (ROADMAP C10's rule). Three columns per rank need four
    ranks: the one rank's whole table must be a width B3 takes (rows of
    16-byte chunks at f32), and half of such a width cuts no table. The
    table is f32 because each rank rounds its partial blend (the residual
    A3-bwd reads) to the table dtype: at a bf16 table the warp's gradients
    part from one rank's by several times the f32 bound on any feature
    split of the ensemble, one that cuts no table too. B3, B4, A3-fwd and
    A3-bwd must launch on every rank. Returns rank 0's launches."""
    from nersemble_tpu_torch.utils.windows import sched_values

    f_cfg = copy.deepcopy(spec["config"])
    f_cfg.hash_ensemble.n_hash_encodings = f_cfg.latent_dim_time = 6
    f_cfg.table_dtype = "float32"
    f = dict(spec, config=f_cfg, layout="tp",
             sched=sched_values(f_cfg, f_cfg.window_hash_encodings_end + 1))
    plain("(f) one rank, 6 tables", dict(f, first_mu_out=str(out_dir / "f_one_mu.npz")))
    (many,) = ranks("(f) 4 gloo ranks, 6 tables, tables 1 and 4 cut", 4, "gloo",
                    [dict(f, first_mu_out=str(out_dir / "f_tp_mu.npz"))])
    gradients("(f) the cut feature split on 4 gloo ranks vs one rank",
              load("f_tp_mu"), load("f_one_mu"))
    kernels = ("quad_build", "quad_fold", "blended_encode_fwd", "blended_encode_bwd")
    per_rank = [{k: counts[k] for k in kernels} for counts in many["rank_launches"]]
    log("parallel", f"(f) launches per rank {per_rank}")
    for rank, counts in enumerate(per_rank):
        for kernel, count in counts.items():
            if count <= 0:
                raise AssertionError(f"(f) rank {rank} never launched {kernel}")
    return many["launches"]


def _serve_ranks_runs(out_dir) -> dict:
    """Phase 16 (e): on a small synthetic capture, the train CLI with
    ``--vis viewer`` (the single-grid model at learning rate 0, two steps, a
    request queued during step 0: ``parallel/compare.viewer_run``) over two
    gloo ranks sharing this card and on one rank: both replies PNGs, the
    frames within SERVE_RANKS_TOL; then the evaluate CLI on the two-rank run
    (config data_axis_size 2: two gloo ranks) and on a copy that says 1: the
    PNGs within one 8-bit level, every metric within SERVE_RANKS_TOL's
    rtol. Returns the two-rank viewer run's launches (rank 0)."""
    import shutil

    import torch
    from nersemble_tpu_torch import env
    from nersemble_tpu_torch.config import TrainConfig
    from nersemble_tpu_torch.parallel import compare, launch
    from nersemble_tpu_torch.scripts import evaluate_nersemble
    from nersemble_tpu_torch.utils import png
    from nersemble_tpu_torch.utils.synthetic_capture import write_capture

    root = out_dir / "serve"
    write_capture(root / "data", 30, "SYN-1", 3, SERVE_RANKS_SIZE)
    saved = {name: getattr(env, name) for name in launch.ENV_ROOTS}
    roots = {"NERSEMBLE_DATA_PATH": str(root / "data"),
             "NERSEMBLE_MODELS_PATH": str(root / "models"),
             "NERSEMBLE_RENDERS_PATH": str(root / "renders")}
    query = {"channel": "rgb", "width": SERVE_VIEW_WIDTH, "az": 0.3}
    try:
        for name, value in roots.items():
            setattr(env, name, value)
        torch.cuda.empty_cache()
        start = time.perf_counter()
        one = compare.viewer_run(None, {
            "argv": SERVE_RANKS_TRAIN + ["--name", "one", "--data-axis-size", "1"],
            "roots": roots, "query": query, "out": str(out_dir / "e_one.npz")})
        one_s = time.perf_counter() - start
        torch.cuda.empty_cache()
        start = time.perf_counter()
        (two,) = launch.spawn(compare.run_many, 2, "gloo", "cuda", [("viewer_run", {
            "argv": SERVE_RANKS_TRAIN + ["--name", "two", "--data-axis-size", "2"],
            "roots": roots, "query": query, "out": str(out_dir / "e_two.npz")})])
        two_s = time.perf_counter() - start
        for what, result in (("one rank", one), ("two gloo ranks", two)):
            log("parallel", f"(e) --vis viewer, {what}: layout {result['layout']}, "
                            f"reply {result['status']} {result['ctype']}, frames "
                            f"{result['frames']}, launches {result['launches']}")
            if (result["status"], result["ctype"], result["frames"]) != (200, "image/png", 1):
                raise AssertionError(f"(e) the viewer over {what} did not serve its frame")
        a, b = np.load(out_dir / "e_two.npz"), np.load(out_dir / "e_one.npz")
        err = float(np.abs(a["frame"] - b["frame"]).max())
        np.testing.assert_allclose(a["frame"], b["frame"], **SERVE_RANKS_TOL)
        if not a["frame"].max() > 0 or np.abs(a["png"].astype(int) - b["png"].astype(int)).max() > 1:
            raise AssertionError("(e) the viewer's frame is black or its PNG differs")
        log("parallel", f"(e) the viewer's frame {list(a['frame'].shape)} over two ranks "
                        f"vs one rank: max abs err {err:.3g} (tol {SERVE_RANKS_TOL}); runs "
                        f"{one_s:.1f} s / {two_s:.1f} s with set-up")
        for kernel in ("fused_mlp_fwd", "quad_build", "blended_encode_fwd"):
            if two["launches"][kernel] <= 0:
                raise AssertionError(f"(e) the two-rank viewer run never launched {kernel}")

        runs = root / "models" / "nersemble"
        (two_dir,) = runs.glob("NERS-*-two")
        one_dir = runs / "NERS-099-copy"
        shutil.copytree(two_dir, one_dir)
        config = TrainConfig.load(one_dir / "config.yml")
        config.parallel.data_axis_size = 1
        config.save(one_dir / "config.yml")
        results, seconds = {}, {}
        for what, run in (("two gloo ranks", two_dir.name), ("one rank", one_dir.name)):
            torch.cuda.empty_cache()
            start = time.perf_counter()
            results[what] = evaluate_nersemble.main([run] + SERVE_RANKS_EVAL).to_dict()
            seconds[what] = time.perf_counter() - start
        pngs = [{p.relative_to(d): png.imread(p) for p in (d / "evaluation").rglob("*.png")}
                for d in (two_dir, one_dir)]
        if pngs[0].keys() != pngs[1].keys() or not pngs[0]:
            raise AssertionError(f"(e) the evaluate CLI wrote {len(pngs[0])} / "
                                 f"{len(pngs[1])} images")
        level = max(int(np.abs(pngs[0][k].astype(int) - pngs[1][k].astype(int)).max())
                    for k in pngs[0])
        mean_two, mean_one = (results[w]["mean"]["regular"] for w in results)
        worst = max(abs(mean_two[k] - v) / max(abs(v), 1e-12)
                    for k, v in mean_one.items() if v is not None)
        log("parallel", f"(e) the evaluate CLI over two gloo ranks vs one rank: "
                        f"{len(pngs[0])} images, PNGs within {level} 8-bit level(s), "
                        f"mean metrics {mean_two} vs {mean_one} (worst rel {worst:.3g}); "
                        f"{seconds['two gloo ranks']:.1f} s / {seconds['one rank']:.1f} s")
        if level > 1 or worst > SERVE_RANKS_TOL["rtol"]:
            raise AssertionError("(e) the evaluate CLI over two ranks differs from one rank")
    finally:
        for name, value in saved.items():
            setattr(env, name, value)
    return two["launches"]


def trained_scene_phase(device) -> dict:
    """A trained, carved scene (phase 15): (a) the quality benchmark's
    static run, (b) the render benchmark and the viewer on it, (c) the pose
    figure of its capture. Returns the kernels' launches in (a) and in (b)'s
    filtered and unfiltered renders."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    from nersemble_tpu_torch.config import TrainConfig
    from nersemble_tpu_torch.data.dataparser import NeRSembleDataParser
    from nersemble_tpu_torch.data.multi_view_data import NeRSembleDataManager
    from nersemble_tpu_torch.scripts import trained_scene, validate_poses
    from nersemble_tpu_torch.utils import png

    root = Path(tempfile.mkdtemp(prefix="nersemble_trained_scene_"))
    args = trained_scene.build_parser().parse_args(TRAINED_ARGS + ["--root", str(root)])
    try:
        # (a) the quality run
        train = trained_scene.train_scene(args, device)
        quality, launches = train["quality"], train["launches"]
        curve = [(p["step"], p["eval_psnr"], p["eval_ssim"]) for p in quality["eval_curve"]]
        log("trained scene", f"(a) static quality run, {args.steps} steps in "
                             f"{quality['wall_clock_s']} s ({train['seconds']:.1f} s with "
                             f"the capture), median {train['ms_per_step_median']:.1f} "
                             f"ms/step over the logged intervals; eval (step, PSNR, "
                             f"SSIM) {curve}; all-background image "
                             f"{train['background_psnr']:.3f} dB; final train PSNR "
                             f"{quality['final_train_psnr']}; drops "
                             f"{quality['drop_diagnostics_tail'][-1:]}; peak memory "
                             f"{train['peak_gib']} GiB; launches {launches}")
        if len(curve) < 2 or not curve[-1][1] > curve[0][1]:
            raise AssertionError(f"(a) the last eval PSNR does not beat the first: {curve}")
        if not curve[-1][1] > train["background_psnr"]:
            raise AssertionError(f"(a) the last eval PSNR {curve[-1][1]} does not beat an "
                                 f"all-background image's {train['background_psnr']:.3f}")
        for kernel in TRAIN_KERNELS:
            if launches[kernel] <= 0:
                raise AssertionError(f"(a) the quality run never launched {kernel}")

        # (b) the render benchmark and the viewer on the run: with the CC
        # filter (the render and eval protocol: it must keep cells, which no
        # grid still in its warm-up does), then without it, the grid the run
        # marched in training
        render = trained_scene.render_scene(args, train["run"], device)
        for key, part in render.items():
            extra = part["bench"]["extra"]
            log("trained scene", f"(b) bench_render {extra['resolution']} {key}: "
                                 f"{extra['ms_per_frame']} ms/frame, auto budget "
                                 f"{extra['auto_budget']}, hit fraction "
                                 f"{extra['hit_ray_fraction']}, mean accumulation "
                                 f"{extra['mean_accumulation']}, CC filter cells "
                                 f"{part['bench']['cc_cells']}, peak memory "
                                 f"{part['peak_gib']} GiB, launches per frame "
                                 f"{extra['launches_per_frame']}, in all {part['launches']}")
        filtered, unfiltered = render["filtered"], render["unfiltered"]
        cells, extra = filtered["bench"]["cc_cells"], filtered["bench"]["extra"]
        if cells is None or not cells["kept"] > 0:
            raise AssertionError(f"(b) the CC filter kept no cell: {cells}")
        if not extra["mean_accumulation"] >= 0.01 or not extra["hit_ray_fraction"] > 0:
            raise AssertionError(f"(b) the filtered orbit renders (almost) nothing: {extra}")
        for key, part in render.items():
            for kernel in FRAME_KEYS:
                if part["launches"][kernel] <= 0:
                    raise AssertionError(f"(b) bench_render {key} never launched {kernel}")
        view = trained_scene.view_scene(args, train["run"], device)
        log("trained scene", f"(b) viewer at width {trained_scene.VIEW_WIDTH}: ms per "
                             f"request {[round(ms, 1) for ms, _ in view['requests']]}, "
                             f"peak memory {view['peak_gib']} GiB")

        # (c) the pose figure: it decodes, and the capture's train cameras
        # are drawn at their centres
        data = TrainConfig.load(Path(quality["run_dir"]) / "config.yml").data
        figure = root / "validate_poses.png"
        geometry = validate_poses.main(
            [str(data.participant_id), data.sequence_name, "--output", str(figure),
             "--device", str(device)], data_location=str(root / "data"))
        image = png.imread(figure)
        centers = NeRSembleDataParser(data, NeRSembleDataManager(
            data.participant_id, data.sequence_name, location=str(root / "data"))
        ).generate_outputs("train").c2w[:, :3, 3]
        fig = validate_poses.Figure(geometry)
        drawn = [image[r, c] for view_idx in range(len(validate_poses.VIEWS))
                 for r, c in fig.pixels(geometry["centers"], view_idx)]
        log("trained scene", f"(c) validate_poses: {figure.name} {image.shape} "
                             f"{image.dtype}, {len(centers)} train cameras")
        if image.shape != (validate_poses.PANEL, 3 * validate_poses.PANEL, 3):
            raise AssertionError(f"(c) the pose figure is {image.shape}")
        if not np.array_equal(geometry["centers"], centers):
            raise AssertionError("(c) the plotted centres differ from the dataparser's")
        if not all(tuple(px) == validate_poses.CAMERA for px in drawn):
            raise AssertionError("(c) a camera centre is not drawn at its pixel")
        return {"train": launches, "render": filtered["launches"],
                "render unfiltered": unfiltered["launches"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def main() -> None:
    import sys

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on an NVIDIA GPU")
    from nersemble_tpu_torch.config import flagship_model_config
    from nersemble_tpu_torch.engine.renderer import Renderer
    from nersemble_tpu_torch.models.nersemble import NeRSembleModel
    from nersemble_tpu_torch.ops import cuda_lib, fused_mlp, launch_counts
    from nersemble_tpu_torch.ops.hash_encoding import HashGridLevels
    from nersemble_tpu_torch.utils.bench_data import bench_grid
    from nersemble_tpu_torch.utils.cameras import add_contrast, pinhole_frame
    from nersemble_tpu_torch.utils.timing import nvidia_smi
    from nersemble_tpu_torch.utils.windows import sched_values

    # ---- 1. device ----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log("device", f"{name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(nvidia_smi(), flush=True)

    # ---- 2. build -------------------------------------------------------------
    start = time.perf_counter()
    cuda_lib.library()
    log("build", f"kernels ready in {time.perf_counter() - start:.1f} s "
                 f"({cuda_lib.library_path().name})")
    for line in (cuda_lib.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line or line.startswith("# "):
            log("build", line.strip())

    if sys.argv[1:] == ["--parallel-only"]:  # phase 16 alone; no result line
        log("parallel", f"launches {parallel_phase()}")
        return

    # ---- 3. kernels vs plain at the flagship shapes ---------------------------
    cfg = flagship_model_config(tiny=False)
    hc = cfg.hash_ensemble.hash_encoding
    levels = HashGridLevels.create(hc.n_levels, hc.log2_hashmap_size,
                                   hc.base_resolution, hc.per_level_scale)
    kernel_results = kernel_phase(cfg, levels, device)
    kernel_results.update(encode_kernel_phase(cfg, levels, device))

    # ---- 3b. the measurement path's copy kernels vs plain ----------------------
    kernel_results.update(copy_kernel_phase(levels, device))

    # ---- 3c. Adam at the flagship's leaves vs the plain update -----------------
    kernel_results.update(adam_kernel_phase(device))

    # ---- 3d. the time codes' backward at the cells' shapes ---------------------
    kernel_results.update(time_code_phase(cfg, device))

    # ---- 4. render ------------------------------------------------------------
    model = NeRSembleModel(cfg, device)
    params = add_contrast(model.init_params(
        torch.Generator(device=device).manual_seed(SEED)))
    grid_occs = bench_grid(cfg.grid_resolution).to(device)
    renderer = Renderer(model, params, grid_occs)
    frames = [pinhole_frame(FRAME_H, FRAME_W, ts) for ts in TIMESTEPS]
    step = cfg.window_hash_encodings_end  # end of schedule: windows 7 and 32
    log("render", f"flagship: table {tuple(params.field.table.shape)}, "
                  f"{levels.n_levels} levels, S={cfg.sampling.max_samples_per_ray}, "
                  f"candidates {model.config.sampling.max_candidates_per_ray}; "
                  f"step {step}: {sched_values(cfg, step)}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts.reset()
    fused_mlp.ROWS = collections.Counter()
    start = time.perf_counter()
    images = [renderer.render_image(frame, step, chunk=CHUNK) for frame in frames]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    render_rows, fused_mlp.ROWS = fused_mlp.ROWS, None
    render_launches = launch_counts.read(launch_counts.FORWARD)

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
    for kernel, count in render_launches.items():
        if count <= 0:
            raise AssertionError(f"the render path never launched {kernel}")
    log("render", f"3 frames {FRAME_W}x{FRAME_H}: {1e3 * elapsed / len(frames):.1f} "
                  f"ms/frame, hit fraction {hit_fraction:.4f}, "
                  f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
                  f"launches {render_launches}")
    rows_histogram(f"render: {len(frames)} frames", cfg, render_rows)

    # ---- 5. profile -------------------------------------------------------------
    profile_run("profile", lambda: renderer.render_image(frames[1], step, chunk=CHUNK),
                PROFILE_RANGES, "frame")
    renderer._fparams = None  # free the cached quad table before training
    torch.cuda.empty_cache()

    # ---- 6.-7. train and its profile ----------------------------------------------
    train_launches, train_step_ms = train_phase(cfg, device)
    torch.cuda.empty_cache()

    # ---- 6b. repeat: a step repeats and resumes bit for bit (C11) ----------------
    repeat_phase()

    # ---- 8. train reference: the tiny step on the GPU vs the CPU path ------------
    train_reference_phase(device)

    # ---- 9. reference: the GPU render vs the port's CPU path ------------------
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

    del cpu_renderer, renderer, params
    torch.cuda.empty_cache()

    # ---- 10. bench --------------------------------------------------------------
    bench_phase(train_step_ms)

    # ---- 11. diagnostics: the measurement scripts --------------------------------
    launches = {**train_launches, **diagnostics_phase()}

    # ---- 12.-14. sequence, serve and variants on a capture on disk ---------------
    variant_launches = sequence_phase(train_step_ms)

    # ---- 15. a trained scene: quality run, render bench, viewer, poses ----------
    trained_launches = trained_scene_phase(device)

    # ---- 16. parallel: the multi-device layouts ----------------------------------
    parallel_launches = parallel_phase()

    sources = {
        "fused_mlp_fwd": ("fused_mlp_fwd.cu", "nersemble_tpu/ops/fused_mlp.py:71"),
        "fused_mlp_bwd": ("fused_mlp_bwd.cu", "nersemble_tpu/ops/fused_mlp.py:83"),
        "quad_build": ("quad_build.cu", "nersemble_tpu/ops/quad_pallas.py:162"),
        "quad_fold": ("quad_fold.cu", "nersemble_tpu/ops/quad_pallas.py:221"),
        "gather_rows": ("gather_rows.cu", "scripts/pallas_gather_probe.py:36"),
        "copy": ("copy_ladder.cu", "scripts/bench_quad_build.py:76"),
        "bcast_quarters": ("copy_ladder.cu", "scripts/bench_quad_build.py:92"),
        "fetch7": ("copy_ladder.cu", "scripts/bench_quad_build.py:110"),
        "blended_encode_fwd": ("blended_encode.cu", "nersemble_tpu/ops/hash_encoding.py:545"),
        "blended_encode_bwd": ("blended_encode.cu", "nersemble_tpu/ops/hash_encoding.py:593"),
        "fused_adam": ("fused_adam.cu", "none (XLA elementwise: "
                                        "nersemble_tpu/engine/optimizers.py:47)"),
        "time_code_bwd": ("time_code_bwd.cu", "none (XLA scatter-add, the transpose of "
                                              "nersemble_tpu/models/nersemble.py:146)"),
    }
    print(json.dumps({"kernels": [
        {"name": kernel, "route": "cuda",
         "source": f"nersemble_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": launches[kernel], **kernel_results[kernel],
         **({"variant_launches": {run: counts[kernel] for run, counts
                                  in variant_launches.items()},
             "trained_scene_launches": {part: counts[kernel] for part, counts
                                        in trained_launches.items()},
             "parallel_launches": {run: counts[kernel] for run, counts
                                   in parallel_launches.items()}}
            if kernel in variant_launches["a"] else {})}
        for kernel, (src, replaces) in sources.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
