"""A training cell driven end to end at a tiny size on the CPU: the
reference against the port's CPU path, the control and the planted faults
against the check, and the modules a run loads. The card-only test runs
the control at the cell's own size.

    python -m pytest benchmark -q               # CPU, a few minutes
    python -m pytest benchmark -q -m cuda       # on the card
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import calibrate, check
from benchmark import run as bench_run

HERE = Path(__file__).resolve().parent
TINY_CLI = ["--num-levels", "4", "--log2-hashmap-size", "10", "--max-res", "32",
            "--grid-resolution", "16", "--n-hash-encodings", "4", "--latent-dim-time", "4",
            "--latent-dim-time-deform", "8", "--mlp-num-layers", "2",
            "--mlp-layer-width", "16", "--max-samples-per-ray", "24",
            "--n-train-rays", "256", "--n-timesteps", "3"]
SEED = 2 ** 31 + 101
# the float32 program repeats the float32 reference to rounding
F32 = {"compute_dtype": "float32", "table_dtype": "float32"}


def tiny(config: str, overrides=None):
    """A training cell of configuration ``config`` at a tiny size: its file's
    CLI flags with the tiny widths after them, a 3-timestep 32x44 capture."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    limits = json.loads((HERE / "limits" / "nersemble.json").read_text())
    traffic = json.loads((HERE / "traffic" / "train.json").read_text())
    cfg = {"train_cli": cfg["train_cli"] + TINY_CLI, "model_overrides": overrides or {}}
    traffic = dict(traffic, window_start_step=80020, profile_steps=2,
                   capture=dict(traffic["capture"], n_timesteps=3, original_size=[64, 88]))
    workload = {"name": f"{config}.train", "config": config, "traffic": "train", "chips": 1}
    return workload, cfg, traffic, limits, bench


@pytest.fixture(scope="module")
def capture_root(tmp_path_factory):
    return tmp_path_factory.mktemp("captures")


@pytest.mark.parametrize("config", ["nersemble", "nersemble_single_grid"])
def test_reference_repeats_the_float32_program(config, capture_root):
    wl, cfg, traffic, limits, bench = tiny(config, F32)
    got = calibrate.readings(cfg, traffic, SEED, "sound", "cpu", capture_root)
    assert got["loss"] < 1e-5 and got["samples"] == 0.0
    assert got["grad"] < 1e-5 and got["update"] < 1e-5 and got["render"] < 1e-5
    assert got["batch"] < 1e-5


def test_a_traced_run_prints_every_metric(capture_root):
    wl, cfg, traffic, limits, bench = tiny("nersemble")
    out = bench_run.execute(wl, cfg, traffic, limits, bench, SEED, 1.0, True, "cpu",
                            capture_root=capture_root)
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in bench["per_layer"]}
    # no device on the CPU: the idle share has nothing to read
    assert set(out["metrics"]) == names - {"idle_pct.train"}
    assert list(out)[-1] == "checks"
    untraced = bench_run.execute(wl, cfg, traffic, limits, bench, SEED, 0.5, False, "cpu",
                                 capture_root=capture_root)
    assert set(untraced["metrics"]) == {m["name"] for m in bench["end_to_end"]}


@pytest.mark.parametrize("fault", calibrate.FAULTS)
def test_each_fault_comes_out_not_correct(fault, capture_root):
    """A whole run (set-up, window, check) with the program broken
    underneath: one chip, so no exchange between chips to leave out."""
    wl, cfg, traffic, limits, bench = tiny("nersemble")
    with calibrate.fault(fault):
        out = bench_run.execute(wl, cfg, traffic, limits, bench, SEED, 0.3, False, "cpu",
                                capture_root=capture_root)
    assert not out["correct"], out["checks"]


def test_the_control_reads_above_the_program(capture_root):
    """At this size the float8 control's numbers are not held to the cell's
    limits (those are set at the cell's size); it has to read well above
    the sound program on the same seed."""
    wl, cfg, traffic, limits, bench = tiny("nersemble")
    sound = calibrate.readings(cfg, traffic, SEED, "sound", "cpu", capture_root)
    control = calibrate.readings(cfg, traffic, SEED, "control", "cpu", capture_root)
    assert control["render"] > 3 * sound["render"]


def test_a_run_loads_no_jax(capture_root):
    code = f"""
import sys, json
sys.path.insert(0, {str(HERE.parent)!r})
from benchmark.test_bench_cell import tiny
from benchmark import run as R
wl, cfg, traffic, limits, bench = tiny("nersemble")
R.execute(wl, cfg, traffic, limits, bench, 7, 0.3, False, "cpu", capture_root={str(capture_root)!r})
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in R.FORBIDDEN)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wl, cfg, traffic, limits, bench = bench_run.load_cell("nersemble.train")
    got = calibrate.readings(cfg, traffic, SEED, "control", "cuda:0")
    assert not check.judge(got, limits)["correct"], got
