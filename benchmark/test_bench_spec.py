"""The benchmark's files against its contract, and its counts against
shapes worked out by hand. CPU only; fast.

    python -m pytest benchmark -q
"""

import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import capture, roofline, weights
from benchmark.loops.train import grid_seed, trainer_seed
from benchmark.reference.nersemble_ref import Reference, grid_layout

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# every configuration file, also those no cell uses yet
CONFIGS = {p.stem: json.loads(p.read_text()) for p in (HERE / "configs").glob("*.json")}


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in BENCH["workloads"]] \
        + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        layers.setdefault(m["layer"], []).append(m["name"])
        assert "\n" not in m["layer"] and "\t" not in m["layer"]
    for text in [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text


def test_every_file_a_cell_names_is_there():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert CONFIGS[c["name"]]["source"] and set(c["reduced"]) <= set(CONFIGS[c["name"]]["model"])
        assert json.loads((HERE / "limits" / f"{c['name']}.json").read_text())
    for w in BENCH["workloads"]:
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (HERE / "loops" / f"{traffic['loop']}.py").is_file()
        assert w["chips"] in (1, 4) and w["config"] in CONFIGS
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def test_configs_keep_every_width():
    """Only the timestep count is cut; the widths are the published ones."""
    for name, cfg in CONFIGS.items():
        assert cfg["reduced"] == ["n_timesteps"]
        m = cfg["model"]
        assert m["n_timesteps"] == 16
        assert m["deformation_field"]["mlp_layer_width"] == 128
        assert m["deformation_field"]["mlp_num_layers"] == 6
        assert m["deformation_field"]["warp_code_dim"] == 128
        assert m["latent_dim_time"] == 32 and m["hidden_dim"] == 64
        assert m["sampling"]["max_samples_per_ray"] == 256
    he = CONFIGS["nersemble"]["model"]["hash_ensemble"]
    assert he["n_hash_encodings"] == 32 and he["hash_encoding"]["log2_hashmap_size"] == 19
    assert not CONFIGS["nersemble_single_grid"]["model"]["use_hash_ensemble"]


def test_table_layouts_are_the_published_sizes():
    ens = grid_layout(CONFIGS["nersemble"]["model"])
    assert (ens["entries"], ens["width"]) == (6537216, 64)
    single = grid_layout(CONFIGS["nersemble_single_grid"]["model"])
    assert single["width"] == 2 and single["n_levels"] == 16
    assert single["entries"] < ens["entries"]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_the_reference_budget_is_the_configurations_own(config):
    """0.125 of 4096 rays x 256 samples, the train CLI's starting budget and
    its cap at one 98,304-sample chunk (the larger of the two)."""
    ref = Reference(CONFIGS[config]["model"], "cpu")
    assert ref.budget(4096) == 131072


def test_traffic_repeats_from_a_seed():
    big = 2 ** 31 + 12345
    m = dict(CONFIGS["nersemble_single_grid"]["model"], grid_resolution=8)
    a, b = weights.make(m, big, "cpu"), weights.make(m, big, "cpu")
    c = weights.make(m, big + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["field.table"], c["field.table"])
    ref = Reference(m, "cpu")
    grid = ref.probe_every_cell(a, grid_seed(big), 80016)
    assert grid.shape == (8 ** 3,) and bool((grid >= 0).all())
    assert torch.equal(grid, ref.probe_every_cell(b, grid_seed(big), 80016))
    assert not torch.equal(grid, ref.probe_every_cell(c, grid_seed(big + 1), 80016))
    assert trainer_seed(big) < 2 ** 30


def test_capture_repeats(tmp_path):
    spec = {"participant_id": 30, "sequence": "SYN-1", "n_timesteps": 2,
            "n_cameras": 16, "original_size": [32, 44]}
    one = capture.write(tmp_path / "a", spec)
    two = capture.write(tmp_path / "b", spec)
    files = sorted(p.relative_to(one) for p in one.rglob("*.png"))
    assert len(files) == 2 * 16 * 3
    assert all((one / f).read_bytes() == (two / f).read_bytes() for f in files)


def test_adam_bytes_by_hand():
    # 6,537,216 x 64 float32 parameters: 7 arrays of 4 bytes each
    n = 6537216 * 64
    assert roofline.adam_bound_ms(n) == pytest.approx(1e3 * 28 * n / 3.35e12)


def test_encode_bytes_by_hand():
    lv = {"n_levels": 16, "features": 2, "width": 64}
    # 1000 samples touching 5000 rows of 64 floats; positions 3, codes 32,
    # features 32 floats a sample
    assert roofline.encode_bytes(1000, 5000, lv, 32) == 4 * (5000 * 64 + 1000 * (3 + 32 + 32))


def test_mlp_counts_by_hand():
    # the density MLP: 32 -> 64 -> 16, 100 rows
    shapes = [(32, 64), (64, 16)]
    assert roofline.mlp_macs(shapes) == 32 * 64 + 64 * 16
    flops = 4.0 * 100 * (32 * 64 + 64 * 16)
    n_bytes = 4 * 100 * (2 * 32 + 16)
    assert roofline.mlp_bwd_bound_ms(100, shapes) == pytest.approx(
        1e3 * max(n_bytes / 3.35e12, flops / 989e12))


def test_model_flops_by_hand():
    stem = 173 * 128 + 3 * 128 * 128 + 301 * 128 + 128 * 128 + 128 * 6
    density = 32 * 64 + 64 * 16
    colour = 18 * 64 + 64 * 64 + 64 * 3
    for name in CONFIGS:
        got = roofline.model_flops_per_sample(CONFIGS[name]["model"])
        assert got == 6.0 * (stem + density + colour)


def test_metric_readers_read_nothing_from_nothing():
    import importlib.util
    empty = {"steps": 0, "window_s": 0.0, "layers": {}, "batch_wait_s": [],
             "evaluated_samples": 0.0, "model": CONFIGS["nersemble"]["model"],
             "profile": {}}
    for m in BENCH["per_layer"]:
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(m["name"], path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        assert module.read(empty) is None, m["name"]


def test_profile_parse_counts_busy_and_gaps():
    from benchmark import profile
    events = [
        {"ph": "X", "name": "bench:step", "cat": "user_annotation", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "name": "aten::add", "cat": "cpu_op", "ts": 0, "dur": 20, "tid": 1},
        {"ph": "X", "name": "k1", "cat": "kernel", "ts": 20, "dur": 30, "tid": 7},
        {"ph": "X", "name": "k2", "cat": "kernel", "ts": 40, "dur": 20, "tid": 7},
        {"ph": "X", "name": "k1", "cat": "kernel", "ts": 80, "dur": 40, "tid": 7},
    ]
    out = profile.parse(events)
    assert out["window_s"] == pytest.approx(120e-6)
    assert out["busy_s"] == pytest.approx(80e-6)
    assert out["device_ops"][0] == ["k1", pytest.approx(70e-6)]
    gaps = dict(out["idle_gaps"])
    assert gaps["aten::add"] == pytest.approx(20e-6) and gaps["bench:step"] == pytest.approx(20e-6)
    assert math.isclose(sum(gaps.values()), 40e-6)
