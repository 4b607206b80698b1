"""The dense training cell (``loops/train_dense.py``) driven end to end at a
tiny size on the CPU: the reference against the port's CPU path, the
traced run's metrics, the control and the planted faults against the
check, a step that drops samples counted in ``failed``, and a program
whose train CLI builds another march refused at once. The card-only test
runs the control at the cell's own size.

    python -m pytest benchmark/test_bench_dense.py -q            # CPU
    python -m pytest benchmark/test_bench_dense.py -q -m cuda    # the card
"""

from pathlib import Path

import pytest
import torch

from benchmark import calibrate_dense, check
from benchmark import run as bench_run
from benchmark.loops import train as train_loop
from benchmark.loops.train_dense import DenseTrainCell, check_sampling
from benchmark.reference.nersemble_ref import Reference
from benchmark.test_bench_cell import F32, SEED

HERE = Path(__file__).resolve().parent
# test_bench_cell.py's tiny widths; the march keeps the CLI's own S
TINY_CLI = ["--num-levels", "4", "--log2-hashmap-size", "10", "--max-res", "32",
            "--grid-resolution", "16", "--n-hash-encodings", "4", "--latent-dim-time", "4",
            "--latent-dim-time-deform", "8", "--mlp-num-layers", "2",
            "--mlp-layer-width", "16", "--n-train-rays", "256", "--n-timesteps", "3"]
NAME = "nersemble_seq97.train"


def tiny(overrides=None):
    """The dense cell at a tiny size: its configuration's CLI flags with the
    tiny widths after them, a 3-timestep 32x44 capture."""
    workload, config, traffic, limits, bench = bench_run.load_cell(NAME, HERE.parent)
    cfg = {"train_cli": config["train_cli"] + TINY_CLI, "model_overrides": overrides or {}}
    traffic = dict(traffic, window_start_step=80020, profile_steps=2, spans_steps=3,
                   capture=dict(traffic["capture"], n_timesteps=3, original_size=[64, 88]))
    return workload, cfg, traffic, limits, bench


@pytest.fixture(scope="module")
def capture_root(tmp_path_factory):
    return tmp_path_factory.mktemp("captures")


def test_the_reference_repeats_the_float32_program(capture_root):
    wl, cfg, traffic, limits, bench = tiny(F32)
    got = calibrate_dense.readings(cfg, traffic, SEED, "sound", "cpu", capture_root)
    assert got["loss"] < 1e-5 and got["samples"] == 0.0 and got["batch"] < 1e-5
    assert got["grad"] < 1e-5 and got["update"] < 1e-5 and got["render"] < 1e-5
    assert got["dropped_program"] == [0.0, 0.0, 0.0]


def test_a_traced_run_prints_the_cells_metrics(capture_root):
    wl, cfg, traffic, limits, bench = tiny()
    out = bench_run.execute(wl, cfg, traffic, limits, bench, SEED, 1.0, True, "cpu",
                            capture_root=capture_root)
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in bench_run.cell_metrics(bench, wl, "per_layer")}
    assert names == {"mfu.train", "eval_padding_pct.train_dense",
                     "field_chunk_host_ms.train_dense", "batch_wait_ms.train",
                     "samples_per_step.train", "adam_roofline.train",
                     "time_code_bwd_ms.train", "encode_fwd_roofline.train",
                     "encode_bwd_roofline.train", "mlp_bwd_roofline.train",
                     "idle_pct.train"}
    # no device on the CPU: the idle share has nothing to read
    assert set(out["metrics"]) == names - {"idle_pct.train"}
    assert 0 <= out["metrics"]["eval_padding_pct.train_dense"]["value"] < 2.0
    untraced = bench_run.execute(wl, cfg, traffic, limits, bench, SEED, 0.5, False, "cpu",
                                 capture_root=capture_root)
    assert set(untraced["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert "occupancy" not in untraced["checks"]


def test_set_up_probes_no_starting_grid(capture_root, monkeypatch):
    """A march without a grid reads none: the cell starts from every cell
    occupied, and the reference's probe of every cell never runs."""
    def probe(*args, **kwargs):
        raise AssertionError("the starting grid was probed")
    monkeypatch.setattr(Reference, "probe_every_cell", probe)
    wl, cfg, traffic, limits, bench = tiny()
    cell = DenseTrainCell(cfg, traffic, SEED, "cpu", capture_root=capture_root)
    try:
        cell.build()
        assert torch.equal(cell.start_grid, torch.ones_like(cell.start_grid))
        assert train_loop.Reference is Reference
    finally:
        cell.close()


@pytest.mark.parametrize("fault", calibrate_dense.FAULTS)
def test_each_fault_comes_out_not_correct(fault, capture_root):
    wl, cfg, traffic, limits, bench = tiny()
    with calibrate_dense.fault(fault):
        out = bench_run.execute(wl, cfg, traffic, limits, bench, SEED, 0.3, False, "cpu",
                                capture_root=capture_root)
    assert not out["correct"], out["checks"]
    if fault == "dropped_samples":  # every window step dropped samples
        assert not out["checks"]["samples"]["value"] <= 0.0
        assert out["failed"] == out["attempted"] > 0


def test_the_control_reads_above_the_program(capture_root):
    wl, cfg, traffic, limits, bench = tiny()
    sound = calibrate_dense.readings(cfg, traffic, SEED, "sound", "cpu", capture_root)
    control = calibrate_dense.readings(cfg, traffic, SEED, "control", "cpu", capture_root)
    assert control["render"] > 3 * sound["render"]


def test_a_program_that_builds_another_march_is_refused_at_once():
    """The flags without the README's two build the flagship's march."""
    config = bench_run.load_cell(NAME, HERE.parent)[1]
    check_sampling(config)
    with pytest.raises(ValueError, match="builds"):
        check_sampling(dict(config, train_cli=config["train_cli"][:-3]))


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wl, cfg, traffic, limits, bench = bench_run.load_cell(NAME)
    got = calibrate_dense.readings(cfg, traffic, SEED, "control", "cuda:0")
    assert not check.judge(got, limits)["correct"], got
