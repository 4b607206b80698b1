"""The dynamic run's tools at a tiny size on the CPU (no JAX):
``scripts/dynamic_record.py`` (the port's run of the JAX package's
recorded dynamic quality run: a run stopped at the resume boundary, its
config.yml compressed, resumed), ``scripts/dynamic_forensics.py`` (per
timestep rows of the time embeddings and their Adam ``nu``, the timesteps
that reach the time codes) and ``scripts/dynamic_ablations.py``'s
configurations.

The train CLI gets the tiny sizes after the scripts' arguments (the last
value of a flag wins), as tests/test_torch_quality_render.py does.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from nersemble_tpu_torch.config import TrainConfig
from nersemble_tpu_torch.scripts import dynamic_ablations, dynamic_forensics, dynamic_record
from nersemble_tpu_torch.scripts import train_nersemble as tcli

TINY = ["--n-train-rays", "64", "--num-levels", "4", "--log2-hashmap-size", "9",
        "--max-res", "32", "--grid-resolution", "16", "--mlp-num-layers", "2",
        "--mlp-layer-width", "16", "--max-samples-per-ray", "24"]
# the record's legs at a tiny size: a 60-step schedule stopped after step
# 16, compressed (fade-in end 24, eps-depth end 8) and resumed to step 32
SIZES = {"schedule_steps": 60, "resume_at": 16, "end": 32, "eval_every": 16,
         "n_tables": 4, "fade_end": 24, "eps_depth_end": 8}


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    """The tiny record's run, on two torch threads: its ops are too small to
    gain from more, and the tier-1 run's workers share the host's cores
    (at 8 threads each, two such files took six times as long together as
    apart)."""
    root = tmp_path_factory.mktemp("record")
    main = tcli.main
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tcli, "main", lambda argv, **kw: main(list(argv) + TINY, **kw))
            result = dynamic_record.main(["--device", "cpu", "--root", str(root),
                                          "--out", str(root / "record.json")], **SIZES)
    finally:
        torch.set_num_threads(threads)
    return root, result


def _metrics(run_dir: Path) -> list:
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_record_resumes_with_the_compressed_schedule(record):
    """Both legs write one run; the resumed leg reads the compressed
    config.yml (the port's train CLI reloads the run's config on resume,
    as the JAX CLI does), so the fade-in ends at step 24, not at the
    60-step schedule's 51."""
    root, result = record
    run_dir = root / "models" / "nersemble" / result["run"]
    config = TrainConfig.load(run_dir / "config.yml")
    assert config.model.window_hash_encodings_end == SIZES["fade_end"]
    assert config.model.eps_depth_end_step == SIZES["eps_depth_end"]
    assert result["schedule_edit"]["window_hash_encodings_end"] == [51, 24]
    window = {rec["step"]: rec["window_param/window_hash"]
              for rec in _metrics(run_dir) if "window_param/window_hash" in rec}
    # leg 1 logs the 60-step schedule's window; leg 2 the compressed one's
    # end: every table faded in by step 24
    assert window[max(window)] == SIZES["n_tables"]
    assert max(window) == SIZES["end"] and window[0] == 1.0
    steps = [p["step"] for p in result["eval_curve"]]
    assert steps == [16, 32]
    assert np.isfinite([p["eval_psnr"] for p in result["eval_curve"]]).all()
    assert json.loads((root / "record.json").read_text())["run"] == result["run"]


def test_curve_is_printed_beside_the_record():
    rows = dynamic_record.curve_beside_record([
        {"step": 750, "branch": 0, "eval_psnr": 14.0},
        {"step": 3750, "branch": 0, "eval_psnr": 17.0},
        {"step": 3750, "branch": 1, "eval_psnr": 16.5},
        {"step": 100, "branch": 1, "eval_psnr": 13.0}])
    assert rows == [(100, 13.0, None), (750, 14.0, 14.099), (3750, 16.5, 16.71)]


def test_forensics_reads_every_timestep(record):
    """The last checkpoint's rows, one per timestep of the capture, and the
    timesteps of one batch: every timestep of its rays reaches the time
    codes, none that is not in its rays."""
    _, result = record
    report = result["forensics"]
    assert report["checkpoint"] == "step-000000032.ckpt"
    for key in dynamic_forensics.TIME_KEYS:
        rows = report["rows"][key]
        assert len(rows["norm"]) == len(rows["nu_max"]) == 16
        assert all(np.isfinite(rows["norm"]))
        assert len(rows["rows_without_gradient"]) < 16
    hist = report["timesteps"]
    rays, samples = np.array(hist["rays"]), np.array(hist["samples"])
    assert rays.sum() == 64 and hist["calls"] >= 1
    np.testing.assert_array_equal(samples > 0, rays > 0)


def test_forensics_names_rows_without_a_gradient():
    flat = {"params/time_embedding": np.ones((3, 2), np.float32),
            "opt_state/nu/time_embedding": np.array([[1e-9, 0.0], [0.0, 0.0],
                                                     [0.0, 2e-12]], np.float32)}
    report = dynamic_forensics.row_report(flat)
    assert list(report) == ["time_embedding"]
    assert report["time_embedding"]["rows_without_gradient"] == [1]
    np.testing.assert_allclose(report["time_embedding"]["norm"], [np.sqrt(2)] * 3)


@pytest.mark.parametrize("variant", sorted(dynamic_ablations.VARIANTS))
def test_ablation_flags_build_a_config(variant):
    from nersemble_tpu_torch.scripts import quality_benchmark

    argv = quality_benchmark.build_train_args("dynamic", 1500, "SYN-Q-DYNAMIC", 250) \
        + dynamic_ablations.VARIANTS[variant]
    config = tcli.build_config(tcli.build_parser().parse_args(argv), "x", "/m")
    assert config.model.use_deformation_field == (variant != "no-deformation")
    assert config.model.use_hash_ensemble == (variant != "single-grid")
