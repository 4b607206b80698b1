"""The port's quality benchmark, render benchmark, pose validation and
trained-scene script against the JAX package's scripts: the train-CLI
arguments and the configs they build, the result dict and its branch index
across a resume, the render benchmark's JSON line with and without the CC
filter and its warning on an empty trajectory, the plotted pose geometry,
and the refusal to run without CUDA unless asked for the CPU. The runs are
tiny and on the CPU."""

import ast
import importlib.util
import json
from pathlib import Path

import imageio.v3 as iio
import numpy as np
import pytest
import torch
from torch_parity import REPO

import nersemble_tpu_torch.env as tenv
from nersemble_tpu.config import DataConfig as JDataConfig
from nersemble_tpu.data.dataparser import NeRSembleDataParser as JParser
from nersemble_tpu.data.multi_view_data import NeRSembleDataManager as JDM
from nersemble_tpu.scripts import train_nersemble as jcli
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.scripts import bench_render, quality_benchmark, trained_scene
from nersemble_tpu_torch.scripts import train_nersemble as tcli
from nersemble_tpu_torch.scripts import validate_poses
from nersemble_tpu_torch.utils import png

CPU = ["--device", "cpu"]
# tests/test_cli.py's smoke sizes (the candidate count stays auto-sized: a
# fixed 64 cannot span the scene box and the static field learns nothing)
TINY = ["--n-train-rays", "256", "--num-levels", "4", "--log2-hashmap-size", "9",
        "--max-res", "32", "--grid-resolution", "16", "--mlp-num-layers", "2",
        "--mlp-layer-width", "16", "--max-samples-per-ray", "24"]
TINY_RENDER = ["--frames", "2", "--downscale", "4", "--chunk", "1024"]


def _tiny_train_cli(monkeypatch):
    """The train CLI with the tiny sizes after the benchmark's arguments
    (the last value of a flag wins)."""
    main = tcli.main
    monkeypatch.setattr(tcli, "main", lambda argv, **kw: main(list(argv) + TINY, **kw))


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _source(name: str) -> ast.Module:
    return ast.parse((REPO / "scripts" / f"{name}.py").read_text())


def _jax_flags(name: str) -> dict:
    """option -> default of every ``add_argument`` in a JAX script, read
    from its source (its parser is built in main): a constant expression's
    value, ``"<expr>"`` for one that names the script's globals."""
    flags = {}
    for node in ast.walk(_source(name)):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            default = None
            if "default" in kw:
                try:
                    default = eval(compile(ast.Expression(kw["default"]), name, "eval"), {})
                except NameError:
                    default = "<expr>"
            elif getattr(kw.get("action"), "value", None) == "store_true":
                default = False
            flags[node.args[0].value] = default
    return flags


def _port_flags(parser) -> dict:
    return {a.option_strings[0] if a.option_strings else a.dest: a.default
            for a in parser._actions if a.dest != "help"}


def _dict_keys(node) -> set:
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def _jax_result_keys() -> set:
    """The keys of the dict the JAX ``run()`` returns."""
    run = next(n for n in ast.walk(_source("quality_benchmark"))
               if isinstance(n, ast.FunctionDef) and n.name == "run")
    ret = next(n for n in ast.walk(run) if isinstance(n, ast.Return))
    return _dict_keys(ret.value)


def _jax_render_keys():
    """(top-level keys, extra keys) of the JAX render benchmark's JSON line."""
    dumps = next(n for n in ast.walk(_source("bench_render"))
                 if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "dumps")
    line = dumps.args[0]
    extra = next(v for k, v in zip(line.keys, line.values) if k.value == "extra")
    return _dict_keys(line), _dict_keys(extra)


# ---------------------------------------------------------------------------
# the quality benchmark's arguments and configs
# ---------------------------------------------------------------------------

ARG_CASES = {
    "static": ("static", 3000, 500, 16, 2000, ""),
    "static-sharp": ("static", 800, 400, 16, 2000, "-sharp"),
    "dynamic-16": ("dynamic", 12000, 500, 16, 2000, ""),
    "dynamic-32": ("dynamic", 22000, 1000, 32, 3000, ""),
    "dynamic-short": ("dynamic", 6000, 500, 16, 2000, "-sharp"),  # fade-in warning
    "dynamic-32-short": ("dynamic", 900, 300, 32, 100, ""),
}


@pytest.mark.parametrize("case", sorted(ARG_CASES))
def test_build_train_args_match_the_jax_script(case, capsys):
    mode, steps, every, tables, save, suffix = ARG_CASES[case]
    seq = f"SYN-Q-{mode.upper()}"
    theirs = _jax_script("quality_benchmark").build_train_args(
        mode, steps, seq, every, n_tables=tables, steps_per_save=save, run_suffix=suffix)
    jax_out = capsys.readouterr().out
    ours = quality_benchmark.build_train_args(
        mode, steps, seq, every, n_tables=tables, steps_per_save=save, run_suffix=suffix)
    assert ours == theirs
    assert capsys.readouterr().out == jax_out  # the fade-in warning, when it fires
    # the two train CLIs build equal configs from them
    t = tcli.build_config(tcli.build_parser().parse_args(ours + CPU), "NERS-001", "/m")
    j = jcli.build_config(jcli.build_parser().parse_args(theirs), "NERS-001", "/m")
    assert t.to_dict() == j.to_dict()


@pytest.mark.parametrize("script,module", [("quality_benchmark", quality_benchmark),
                                           ("bench_render", bench_render)])
def test_cli_flags_match_the_jax_script(script, module):
    theirs, ours = _jax_flags(script), _port_flags(module.build_parser())
    assert set(ours) == set(theirs) | {"--device"} and ours["--device"] == "cuda"
    # where the roots default: under the temporary directory, not the repo
    for flag in ("--data-root", "--models-root"):
        assert Path(ours[flag]).name == Path(theirs[flag]).name
    differ = {flag for flag in theirs if ours[flag] != theirs[flag]}
    assert differ <= {"--data-root", "--models-root", "--out", "--orbit-center"}
    assert ours.get("--out", None) is None  # under --models-root, never the repo
    if script == "bench_render":
        assert tuple(ours["--orbit-center"]) == tuple(theirs["--orbit-center"])


# ---------------------------------------------------------------------------
# a tiny quality run on the CPU, resumed after a simulated kill
# ---------------------------------------------------------------------------

class Killed(Exception):
    """A run stopped from outside (the kill a resume recovers from)."""


@pytest.fixture(scope="module")
def quality(tmp_path_factory):
    with pytest.MonkeyPatch.context() as monkeypatch:
        _tiny_train_cli(monkeypatch)
        return _quality_runs(tmp_path_factory)


def _quality_runs(tmp_path_factory):
    """"killed": 8 static steps (evals at 4 and 8, saves at 4 and 8) whose
    final save raised, so the run's latest checkpoint is step 4's; then
    "resumed": the same run picked up with --resume-run to step 8."""
    root = tmp_path_factory.mktemp("quality")
    data, models = str(root / "data"), str(root / "models")
    argv = ["--mode", "static", "--steps", "8", "--eval-every", "4", "--steps-per-save", "4",
            "--data-root", data, "--models-root", models] + CPU
    original = NeRSembleTrainer.save_run_checkpoint

    def killed_at_the_end(self, step):
        if step == 8:
            raise Killed
        return original(self, step)

    NeRSembleTrainer.save_run_checkpoint = killed_at_the_end
    try:
        with pytest.raises(Killed):
            quality_benchmark.main(argv)
    finally:
        NeRSembleTrainer.save_run_checkpoint = original
    run_dir = Path(models) / "nersemble" / "NERS-001-quality-static"
    killed = quality_benchmark.read_quality_metrics(run_dir / "metrics.jsonl")
    resumed = quality_benchmark.main(argv + ["--resume-run", run_dir.name])
    return {"root": root, "data": data, "models": models, "run_dir": run_dir,
            "killed": killed, "resumed": resumed}


def test_quality_result_has_the_jax_keys(quality):
    result = quality["resumed"]["static"]
    assert set(result) == _jax_result_keys() | {"device", "power_limit"}
    assert (result["device"], result["power_limit"]) == ("cpu", None)
    assert result["mode"] == "static" and result["steps"] == 8 and result["n_timesteps"] == 1
    assert result["run_dir"] == str(quality["run_dir"])
    for point in result["eval_curve"]:
        assert set(point) == {"step", "branch", "eval_psnr", "eval_ssim", "eval_psnr_masked"}
        assert np.isfinite(point["eval_psnr"]) and 0.0 <= point["eval_ssim"] <= 1.0
    assert set(result["final_eval_breakdown"]) == {f"eval_cam{c}_psnr" for c in (3, 6, 11, 15)}
    assert len(result["drop_curve"]) <= 80 and result["drop_diagnostics_tail"]
    # the result file sits under --models-root, keyed by mode
    out = Path(quality["models"]) / "quality.json"
    assert json.loads(out.read_text()) == json.loads(json.dumps(quality["resumed"]))


def test_branch_index_increments_across_a_resume(quality):
    killed = quality["killed"]
    result = quality["resumed"]["static"]
    assert killed["n_resumes"] == 0
    assert [(p["step"], p["branch"]) for p in killed["eval_curve"]] == [(4, 0), (8, 0)]
    assert result["n_resumes"] == 1
    assert [(p["step"], p["branch"]) for p in result["eval_curve"]] == [(4, 0), (8, 0), (8, 1)]
    assert {d["branch"] for d in result["drop_curve"]} == {0, 1}


@pytest.mark.parametrize("n_logs", [5, 80, 159, 334])
def test_drop_curve_is_downsampled_by_the_jax_rule(tmp_path, n_logs):
    """Every (n // 80)-th logged point and the last: the JAX script's rule,
    which keeps between 80 and 160 points of a long run."""
    steps = [3 * i for i in range(n_logs)]
    lines = [json.dumps({"step": s, "budget_dropped_per_batch": float(s),
                         "samples_per_batch": 1.0, "dropped_samples_per_batch": 0.0})
             for s in steps]
    (tmp_path / "metrics.jsonl").write_text("\n".join(lines) + "\n")
    curve = quality_benchmark.read_quality_metrics(tmp_path / "metrics.jsonl")["drop_curve"]
    want = steps[::max(n_logs // 80, 1)]
    want += [] if want[-1] == steps[-1] else [steps[-1]]
    assert [d["step"] for d in curve] == want


def _write_jsonl(path: Path, records) -> Path:
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    return path


NON_FINITE = {
    "finite": ([{"step": 0, "train_loss": 0.5}, {"step": 4, "eval_all_psnr": 14.0}], None),
    "nan-loss": ([{"step": 0, "train_loss": 0.5}, {"step": 70, "train_loss": float("nan")},
                  {"step": 1000, "eval_all_psnr": 13.9}], (70, "train_loss")),
    "inf-eval": ([{"step": 4, "eval_all_psnr": float("inf"), "eval_all_ssim": 1.0}],
                 (4, "eval_all_psnr")),
    "nan-ssim": ([{"step": 4, "eval_all_psnr": 13.0, "eval_all_ssim": float("nan")}],
                 (4, "eval_all_ssim")),
}


@pytest.mark.parametrize("case", sorted(NON_FINITE))
def test_run_refuses_a_non_finite_curve(case, tmp_path, monkeypatch):
    """A run whose logged loss or eval turned non-finite raises (read from
    metrics.jsonl after the train CLI returns); a finite one returns its
    curve. The train CLI is replaced by one that writes the run folder."""
    records, want = NON_FINITE[case]

    def fake_train(argv, **kw):
        run_dir = Path(tenv.NERSEMBLE_MODELS_PATH) / "nersemble" / "NERS-001-quality-static"
        run_dir.mkdir(parents=True)
        _write_jsonl(run_dir / "metrics.jsonl", records)
        return {"train_psnr": 10.0}

    monkeypatch.setattr(tcli, "main", fake_train)
    models = tmp_path / "models"
    (tmp_path / "data").mkdir()
    call = lambda: quality_benchmark.run("static", 8, str(tmp_path / "data"), str(models), 4,
                                         device="cpu")
    assert quality_benchmark.first_non_finite(
        _write_jsonl(tmp_path / "m.jsonl", records)) == want
    if want is None:
        assert call()["final_train_psnr"] == 10.0
    else:
        with pytest.raises(RuntimeError, match=f"{want[1]} is not finite at step {want[0]}"):
            call()


def _cc_grid(value: float, width: int, resolution: int = 32) -> np.ndarray:
    grid = np.full((resolution,) * 3, -5.0)
    grid[10:10 + width, 10:10 + width, 10:10 + width] = value
    return grid.ravel()


# (value, width) of a cube of raw density in an empty grid: below the
# threshold after the thinning blur; above it but erased by the integer
# erosion blur; kept
CC_CASES = {"below-threshold": (0.2, 2), "erased": (5.0, 1), "erased-8-cells": (0.5, 2),
            "kept": (1.0, 2), "kept-large": (1.0, 5)}


@pytest.mark.parametrize("case", sorted(CC_CASES))
def test_cc_filter_names_why_it_kept_nothing(case, capsys):
    """The filter's mask equals the JAX filter's; its largest thresholded
    component before the erosion blur is counted, and an empty mask's
    warning names the step that emptied it."""
    from nersemble_tpu.utils import connected_components as JCC
    from nersemble_tpu_torch.utils import connected_components as TCC
    grid = _cc_grid(*CC_CASES[case])
    mask = TCC.filter_occupancy_grid_mask(grid, 32, threshold=0.05)
    err = capsys.readouterr().err
    assert np.array_equal(mask, JCC.filter_occupancy_grid_mask(grid, 32, threshold=0.05))
    capsys.readouterr()
    cells = TCC.largest_component_cells(grid, 32, threshold=0.05)
    binary = JCC.extract_top_k_connected_component(
        grid.reshape(32, 32, 32), threshold=0.05, sigma_erosion=0.0)[-1]
    assert cells == int(binary.sum())  # sigma 0 leaves the component as it was
    if case.startswith("kept"):
        assert mask.sum() > cells > 0 and err == ""
    elif case == "below-threshold":
        assert cells == 0 and "< threshold 0.05" in err
    else:
        assert cells > 0 and not mask.any()
        assert f"the largest thresholded component, {cells} cells, was erased" in err


# ---------------------------------------------------------------------------
# the render benchmark on that run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,empty", [([], None), (["--no-cc-filter"], False),
                                         (["--no-cc-filter", "--orbit-center", "40", "0", "0"],
                                          True)],
                         ids=["cc-filter", "no-filter", "empty-trajectory"])
def test_bench_render_line(quality, flags, empty, capsys, monkeypatch):
    monkeypatch.setattr(tenv, "NERSEMBLE_DATA_PATH", tenv.NERSEMBLE_DATA_PATH)
    monkeypatch.setattr(tenv, "NERSEMBLE_MODELS_PATH", tenv.NERSEMBLE_MODELS_PATH)
    result = bench_render.main(["--models-root", quality["models"], "--data-root",
                                quality["data"]] + TINY_RENDER + CPU + flags)
    out, err = capsys.readouterr()
    cells = result.pop("cc_cells")
    assert json.loads(out.strip().splitlines()[-1]) == result
    top, extra = _jax_render_keys()
    assert set(result) == top
    assert set(result["extra"]) == extra | {"device", "power_limit", "launches_per_frame"}
    e = result["extra"]
    assert e["run"] == "NERS-001-quality-static" and e["cc_filter"] == (not flags)
    if flags:
        assert cells is None
    else:
        assert set(cells) == {"kept", "component"} and min(cells.values()) >= 0
    assert e["resolution"] == [44, 32] and e["rays_per_frame"] == 44 * 32
    assert e["launches_per_frame"] == {"fused_mlp_fwd": 0.0, "quad_build": 0.0,
                                       "blended_encode_fwd": 0.0}  # CPU
    warned = "WARNING: trajectory renders (almost) nothing" in err
    assert warned == (e["mean_accumulation"] < 0.01)
    if empty is not None:
        assert warned == empty
    if empty:
        assert e["hit_ray_fraction"] == 0.0 and e["auto_budget"] is None
    if empty is False:
        assert e["hit_ray_fraction"] > 0 and e["auto_budget"] > 0


def test_bench_render_resolution_rescales_by_height(quality, monkeypatch):
    """--resolution H W: the capture's intrinsics scaled by the height ratio,
    the principal point recentred (the JAX script's rule)."""
    monkeypatch.setattr(tenv, "NERSEMBLE_DATA_PATH", quality["data"])
    monkeypatch.setattr(tenv, "NERSEMBLE_MODELS_PATH", quality["models"])
    from nersemble_tpu_torch.model_manager import NeRSembleModelFolder
    manager = NeRSembleModelFolder().open_run("NERS-001-quality-static")
    config = manager.load_config()
    config.load_dir = manager.get_checkpoint_folder()
    config.vis = "none"
    trainer = NeRSembleTrainer.from_train_config(config, model_manager=manager,
                                                 eval_only=True, device="cpu")
    intr, height, width = bench_render.frame_intrinsics(trainer, config, (40, 30), 1)
    full = trainer.dataparser.data_manager.load_camera_params().intrinsics
    s = 40 / (trainer.train_outputs.image_height * config.data.downscale_factor)
    ow = trainer.train_outputs.image_width * config.data.downscale_factor
    oh = trainer.train_outputs.image_height * config.data.downscale_factor
    assert (height, width) == (40, 30)
    assert (intr.fx, intr.fy, intr.cx, intr.cy) == (
        full.fx * s, full.fy * s, full.cx * s + (30 - ow * s) / 2.0,
        full.cy * s + (40 - oh * s) / 2.0)


# ---------------------------------------------------------------------------
# validate_poses
# ---------------------------------------------------------------------------

def test_validate_poses_plots_what_the_jax_cli_plots(quality, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    geometry = validate_poses.main(["30", "SYN-Q-STATIC"] + CPU,
                                   data_location=quality["data"])
    assert capsys.readouterr().out.strip() == "[validate-poses] wrote validate_poses.png"
    # what the JAX CLI scatters and quivers (nersemble_tpu/scripts/validate_poses.py)
    config = JDataConfig(participant_id=30, sequence_name="SYN-Q-STATIC",
                         n_timesteps=1, scale_factor=9.0)
    outputs = JParser(config, data_manager=JDM(30, "SYN-Q-STATIC", location=quality["data"])
                      ).generate_outputs("train")
    centers = outputs.c2w[:, :3, 3]
    assert np.array_equal(geometry["centers"], centers)
    assert np.array_equal(geometry["look"], -outputs.c2w[:, :3, 2])
    assert geometry["arrow_length"] == np.linalg.norm(centers, axis=1).mean() * 0.3
    box = outputs.scene_box
    assert np.array_equal(geometry["corners"],
                          [[box[(s >> d) & 1][d] for d in range(3)] for s in range(8)])
    # the figure decodes (also in the JAX package's reader) and shows the
    # cameras at their centres and the box corners
    image = png.imread(tmp_path / "validate_poses.png")
    assert np.array_equal(image, iio.imread(tmp_path / "validate_poses.png"))
    assert image.shape == (validate_poses.PANEL, 3 * validate_poses.PANEL, 3)
    fig = validate_poses.Figure(geometry)
    for view in range(len(validate_poses.VIEWS)):
        for r, c in fig.pixels(geometry["centers"], view):
            assert tuple(image[r, c]) == validate_poses.CAMERA
        assert (image[:, view * validate_poses.PANEL:(view + 1) * validate_poses.PANEL]
                == validate_poses.BOX).all(axis=-1).any()


def test_validate_poses_output_flag(quality, tmp_path):
    target = tmp_path / "poses.png"
    validate_poses.main(["30", "SYN-Q-STATIC", "--output", str(target), "--scale-factor", "4.5"]
                        + CPU, data_location=quality["data"])
    assert png.imread(target).shape == (validate_poses.PANEL, 3 * validate_poses.PANEL, 3)


# ---------------------------------------------------------------------------
# the trained-scene script, and the refusals without CUDA
# ---------------------------------------------------------------------------

def test_trained_scene_runs_its_three_parts(tmp_path, monkeypatch):
    _tiny_train_cli(monkeypatch)
    monkeypatch.setattr(trained_scene, "RENDER_ARGS", TINY_RENDER)
    summary = trained_scene.main(
        ["--mode", "static", "--steps", "4", "--eval-every", "2", "--view-requests", "1",
         "--root", str(tmp_path), "--out", str(tmp_path / "summary.json")] + CPU)
    assert json.loads((tmp_path / "summary.json").read_text()) == \
        json.loads(json.dumps(summary))
    train = summary["train"]
    assert train["quality"]["n_timesteps"] == 1
    assert [p["step"] for p in train["quality"]["eval_curve"]] == [2, 4]
    assert np.isfinite(train["background_psnr"]) and train["ms_per_step_median"] > 0
    render = summary["render"]
    assert set(render) == {"filtered", "unfiltered"}
    assert render["filtered"]["bench"]["extra"]["cc_filter"] is True
    assert render["filtered"]["bench"]["cc_cells"]["kept"] >= 0
    assert render["unfiltered"]["bench"]["extra"]["cc_filter"] is False
    assert render["unfiltered"]["bench"]["cc_cells"] is None
    for part in render.values():
        assert part["bench"]["extra"]["resolution"] == [44, 32]
    (ms, size), = summary["view"]["requests"]
    assert ms > 0 and size > 0
    for part in (summary["train"], summary["view"], *render.values()):
        assert part["peak_gib"] is None  # no device memory off the card


@pytest.mark.parametrize("cli", ["quality_benchmark", "bench_render", "validate_poses",
                                 "trained_scene"])
def test_new_clis_need_cuda_unless_asked_for_the_cpu(cli, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"quality_benchmark": ["--mode", "static", "--steps", "2",
                                  "--data-root", str(tmp_path / "d"),
                                  "--models-root", str(tmp_path / "m")],
            "bench_render": ["--models-root", str(tmp_path / "m")],
            "validate_poses": ["30", "SYN-Q-STATIC", "--output", str(tmp_path / "p.png")],
            "trained_scene": ["--root", str(tmp_path / "r")]}[cli]
    module = {"quality_benchmark": quality_benchmark, "bench_render": bench_render,
              "validate_poses": validate_poses, "trained_scene": trained_scene}[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    assert list(tmp_path.iterdir()) == []  # nothing written before the refusal
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality_benchmark.run("static", 2, str(tmp_path / "d"), str(tmp_path / "m"), 1)
