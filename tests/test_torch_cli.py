"""The port's train CLI and run folders against the JAX package's: config
YAML both ways, the CLI's flags and config tree, a tiny CPU run on a
synthetic capture (tests/synthetic_data.py) with its run folder, resume
(bitwise on the CPU), a run folder each package wrote opened by the other,
and the refusals (eval_only training, no CUDA, the parts not ported)."""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml
from torch_parity import REPO  # noqa: F401  (puts the repo root on sys.path)

import nersemble_tpu.config as jcfg
import nersemble_tpu.env as jenv
import nersemble_tpu_torch.config as tcfg
import nersemble_tpu_torch.env as tenv
from nersemble_tpu.scripts import train_nersemble as jcli
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.scripts import train_nersemble as tcli
from tests.synthetic_data import make_synthetic_dataset

# tests/test_cli.py's smoke flags
TINY = ["--n-train-rays", "64", "--num-levels", "4", "--log2-hashmap-size", "9",
        "--max-res", "32", "--grid-resolution", "16", "--n-hash-encodings", "4",
        "--latent-dim-time", "4", "--latent-dim-time-deform", "8",
        "--mlp-num-layers", "2", "--mlp-layer-width", "16",
        "--max-samples-per-ray", "24", "--max-candidates-per-ray", "64",
        "--window-deform-end", "4", "--window-hash-encodings-begin", "4",
        "--window-hash-encodings-end", "8", "--steps-per-eval-image", "0"]
SEQ = ["30", "SYN-1"]
CPU = ["--device", "cpu"]
# the train CLI's flags for the model's other configurations
VARIANT = ["--no-use-hash-ensemble", "--cone-angle", "0.004", "--early-stop-eps", "1e-4"]
# the keys of the JAX loop's log cadence on a device without memory stats
LOG_KEYS = {"train_loss", "train_psnr", "rays_per_sec", "samples_per_batch",
            "dropped_samples_per_batch", "budget_dropped_per_batch",
            "loss/rgb_loss", "loss/alpha_loss", "loss/empty_loss", "loss/near_loss",
            "loss/depth_loss", "loss/dist_loss", "lr/fields", "lr/deformation_field",
            "lr/embeddings", "window_param/window_deform", "window_param/window_hash",
            "window_param/eps_depth"}


# ---------------------------------------------------------------------------
# configs and YAML
# ---------------------------------------------------------------------------

def _jax_configs():
    """TrainConfigs of the JAX package: defaults, the CLI's defaults, the CLI
    at the tiny flags, and one with strings YAML must quote or fold."""
    default = jcfg.TrainConfig()
    flagship = jcli.build_config(jcli.build_parser().parse_args(SEQ), "NERS-001", "/m")
    tiny = jcli.build_config(jcli.build_parser().parse_args(SEQ + TINY), "NERS-002-x", "/m")
    tiny.load_dir, tiny.load_step = "/m/NERS-002-x/checkpoints", 7
    odd = jcfg.TrainConfig(run_name="it's: 'quoted'", experiment_name="yes",
                           output_dir="/tmp/" + "long/" * 30 + "with spaces in it",
                           method_name="1e-15")
    odd.model.scene_box = [[-1.8, -2.3, -2.5], [1.8, 1.3, 2.0]]
    return {"default": default, "flagship": flagship, "tiny": tiny, "odd": odd}


@pytest.mark.parametrize("name", ["default", "flagship", "tiny", "odd"])
def test_port_reads_the_jax_yaml(name):
    theirs = _jax_configs()[name]
    ours = tcfg.TrainConfig.from_yaml(theirs.to_yaml())
    assert ours.to_dict() == theirs.to_dict()
    assert ours.model.deformation_field is None or \
        isinstance(ours.model.deformation_field.skip_connections, tuple)


@pytest.mark.parametrize("name", ["default", "flagship", "tiny", "odd"])
def test_pyyaml_reads_the_port_yaml(name):
    theirs = _jax_configs()[name]
    text = tcfg.TrainConfig.from_yaml(theirs.to_yaml()).to_yaml()
    assert yaml.safe_load(text) == yaml.safe_load(theirs.to_yaml())
    assert jcfg.TrainConfig.from_yaml(text).to_dict() == theirs.to_dict()
    assert "eps: 1.0e-15" in text
    assert yaml.safe_load(text)["optimizers"]["fields"]["eps"] == 1e-15


@pytest.mark.parametrize("name", ["DataConfig", "ParallelConfig", "TrainConfig"])
def test_run_config_defaults_match(name):
    ours, theirs = getattr(tcfg, name)(), getattr(jcfg, name)()
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    assert ours.to_dict() == theirs.to_dict()


def test_cli_flags_and_defaults_match():
    ours = {a.dest: a.default for a in tcli.build_parser()._actions}
    theirs = {a.dest: a.default for a in jcli.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device", "dist_backend"}
    assert ours["device"] == "cuda" and ours["dist_backend"] is None
    assert {k: ours[k] for k in theirs} == theirs


@pytest.mark.parametrize("argv", [SEQ, SEQ + TINY, SEQ + VARIANT, SEQ + TINY + VARIANT],
                         ids=["defaults", "tiny", "variant", "tiny-variant"])
def test_build_config_matches(argv):
    ours = tcli.build_config(tcli.build_parser().parse_args(argv + CPU), "NERS-003", "/m")
    theirs = jcli.build_config(jcli.build_parser().parse_args(argv), "NERS-003", "/m")
    assert ours.to_dict() == theirs.to_dict()


# ---------------------------------------------------------------------------
# runs on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One tiny capture and the runs of the port's CLI: "smoke" (8 steps,
    saves at 6 and 7), "whole" (10 steps), "part" (6 steps, then resumed
    to 10)."""
    data = tmp_path_factory.mktemp("data")
    models = tmp_path_factory.mktemp("models")
    make_synthetic_dataset(data, n_timesteps=3)
    saved = (tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH,
             jenv.NERSEMBLE_DATA_PATH, jenv.NERSEMBLE_MODELS_PATH)
    tenv.NERSEMBLE_DATA_PATH = jenv.NERSEMBLE_DATA_PATH = str(data)
    tenv.NERSEMBLE_MODELS_PATH = jenv.NERSEMBLE_MODELS_PATH = str(models)
    try:
        results = {
            "smoke": tcli.main(SEQ + TINY + CPU + ["--name", "smoke",
                                                   "--max-num-iterations", "8",
                                                   "--steps-per-save", "6"]),
            "whole": tcli.main(SEQ + TINY + CPU + ["--name", "whole",
                                                   "--max-num-iterations", "10"]),
            "part": tcli.main(SEQ + TINY + CPU + ["--name", "part",
                                                  "--max-num-iterations", "6"]),
        }
        results["resumed"] = tcli.main(SEQ + CPU + ["--resume-run", "NERS-003-part",
                                                    "--max-num-iterations", "10"])
        yield {"data": data, "root": models / "nersemble", "results": results}
    finally:
        (tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH,
         jenv.NERSEMBLE_DATA_PATH, jenv.NERSEMBLE_MODELS_PATH) = saved


def _metrics(run_dir: Path):
    steps = {}
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        record = json.loads(line)
        steps.setdefault(record.pop("step"), {}).update(record)
    return steps


def test_cli_run_folder(runs):
    run_dir = runs["root"] / "NERS-001-smoke"
    assert {p.name for p in run_dir.iterdir()} == {
        "config.yml", "checkpoints", "metrics.jsonl", "dataparser_transforms.json"}
    assert [p.name for p in (run_dir / "checkpoints").iterdir()] == ["step-000000007.ckpt"]
    assert json.loads((run_dir / "dataparser_transforms.json").read_text()) == {
        "transform": np.eye(4)[:3].tolist(), "scale": 9.0}
    result = runs["results"]["smoke"]
    assert result["step"] == 7 and np.isfinite(result["loss"])
    metrics = _metrics(run_dir)
    for step in range(8):
        keys = set(metrics.get(step, {})) - {"wall", "sample_budget"}
        want = set()
        if step == 0:
            want |= {"params/field", "params/deformation", "params/time_embedding",
                     "params/time_embedding_deformation", "params/total"}
        if step % 10 == 0 or step == 7:
            want |= LOG_KEYS
        if step in (6, 7):
            want.add("checkpoint_save_seconds")
        assert keys == want, step
    assert metrics[7]["train_loss"] < metrics[0]["train_loss"]


def test_jax_package_reads_the_port_run(runs):
    from nersemble_tpu.model_manager import NeRSembleModelFolder
    theirs = NeRSembleModelFolder().open_run("NERS-001-smoke").load_config()
    ours = tcfg.TrainConfig.load(runs["root"] / "NERS-001-smoke" / "config.yml")
    assert theirs.to_dict() == ours.to_dict()
    assert theirs.model.n_timesteps == 3 and theirs.model.num_images == 36
    assert theirs.model.sampling.max_candidates_per_ray == 64
    flat = np.load(runs["root"] / "NERS-001-smoke" / "checkpoints" / "step-000000007.ckpt")
    assert int(flat["step"]) == 7 and "extra/sample_budget" in flat.files


def test_resume_is_bitwise_on_the_cpu(runs):
    """6 steps + a resume to 10 == 10 steps in one run: every array of the
    step-9 checkpoint, and the losses logged after the resume."""
    whole = dict(np.load(runs["root"] / "NERS-002-whole" / "checkpoints" / "step-000000009.ckpt"))
    resumed = dict(np.load(runs["root"] / "NERS-003-part" / "checkpoints" / "step-000000009.ckpt"))
    assert whole.keys() == resumed.keys()
    for key in whole:
        assert np.array_equal(whole[key], resumed[key]), key
    metrics = _metrics(runs["root"] / "NERS-003-part")
    assert "params/total" in metrics[6]  # the resumed run started at step 6
    assert runs["results"]["resumed"]["loss"] == runs["results"]["whole"]["loss"]


def test_port_resumes_a_run_the_jax_package_wrote(runs):
    from nersemble_tpu.engine import checkpoints as jckpt
    from nersemble_tpu.engine.optimizers import make_optimizer
    from nersemble_tpu.model_manager import NeRSembleModelFolder
    from nersemble_tpu.models.nersemble import NeRSembleModel as JModel

    manager = NeRSembleModelFolder().new_run(name="jax")
    config = jcli.build_config(jcli.build_parser().parse_args(SEQ + TINY),
                               manager.get_run_name(), str(runs["root"]))
    config.model.n_timesteps = config.data.n_timesteps = 3
    config.model.scene_box = [[-2.5, -1.8, -2.5], [2.2, 1.8, 2.0]]
    config.model.num_images = 36
    manager.save_config(config)
    model = JModel(config.model)
    params = model.init_params(jax.random.PRNGKey(0))
    extra = {"sample_budget": np.asarray(384),
             "sample_counts": np.asarray([500.0, 510.0]),
             "budget_drops": np.asarray([0.0, 3.0])}
    jckpt.save_checkpoint(Path(manager.get_checkpoint_folder()) / "step-000000005.ckpt",
                          5, params, make_optimizer().init(params),
                          model.init_grid_occs(), extra=extra)
    result = tcli.main(SEQ + CPU + ["--resume-run", manager.get_run_name(),
                                    "--max-num-iterations", "8"])
    assert result["step"] == 7 and np.isfinite(result["loss"])
    run_dir = Path(manager.get_location())
    assert "params/total" in _metrics(run_dir)[6]
    ckpt = np.load(run_dir / "checkpoints" / "step-000000007.ckpt")
    assert int(ckpt["extra/sample_budget"]) == 384
    assert list(ckpt["extra/sample_counts"]) == [500.0, 510.0]
    assert [p.name for p in (run_dir / "checkpoints").iterdir()] == ["step-000000007.ckpt"]


def test_eval_only_trainer_refuses_to_train(runs, tmp_path):
    config = tcfg.TrainConfig.load(runs["root"] / "NERS-001-smoke" / "config.yml")
    config.load_dir = str(runs["root"] / "NERS-001-smoke" / "checkpoints")
    config.output_dir = str(tmp_path)  # the trainer's writer opens its run here
    trainer = NeRSembleTrainer.from_train_config(config, eval_only=True, device="cpu")
    assert trainer.start_step == 8
    with pytest.raises(RuntimeError, match="eval_only"):
        trainer.train()
    assert not (tmp_path / "NERS-001-smoke" / "checkpoints").exists()


def test_entry_points_need_cuda_unless_asked_for_the_cpu(runs, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = sorted(p.name for p in runs["root"].iterdir())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(SEQ + TINY + ["--max-num-iterations", "2"])
    assert sorted(p.name for p in runs["root"].iterdir()) == before
    config = tcfg.TrainConfig.load(runs["root"] / "NERS-001-smoke" / "config.yml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NeRSembleTrainer.from_train_config(config)


@pytest.mark.parametrize("flags,ranks", [pytest.param(
    ["--data-axis-size", "2", "--vis", "viewer"], 2, id="flags0-one device")])
def test_parts_not_ported_raise(runs, flags, ranks):
    """Nothing of the CLI is left unported: ``--vis viewer`` over two ranks
    trains, rank 0 serving the viewer between steps (its frames are held to
    one rank's in tests/test_torch_parallel_serve.py). The test and its case
    keep the names they had while ``--data-axis-size 2``, then the viewer
    over several ranks, raised NotImplementedError; the case now checks
    that the run trains and records its ranks and viewer."""
    result = tcli.main(SEQ + TINY + CPU + flags + ["--name", "parts", "--viewer-port", "0",
                                                   "--max-num-iterations", "1"])
    assert result["step"] == 0 and np.isfinite(result["loss"])
    (run_dir,) = runs["root"].glob("NERS-*-parts")
    config = tcfg.TrainConfig.load(run_dir / "config.yml")
    assert (config.vis, config.parallel.data_axis_size) == ("viewer", ranks)


# ---------------------------------------------------------------------------
# the model's other configurations through the CLIs
# ---------------------------------------------------------------------------

class _FakeJod:
    def predict(self, pred, gt, dim_order, frames_per_second):
        return np.float32(8.5), None


@pytest.fixture(scope="module")
def variant_runs(tmp_path_factory):
    """A tiny capture and two runs of the model's other configurations:
    "NERS-001-variant", 8 steps of the port's train CLI with the single-grid
    field, a cone angle and early stop; "NERS-002-jax", a config.yml and a
    step-3 checkpoint the JAX package wrote for the same flags plus SH
    degree 4 and the appearance embedding."""
    from nersemble_tpu.engine import checkpoints as jckpt
    from nersemble_tpu.engine.optimizers import make_optimizer
    from nersemble_tpu.model_manager import NeRSembleModelFolder
    from nersemble_tpu.models.nersemble import NeRSembleModel as JModel

    data = tmp_path_factory.mktemp("data")
    models = tmp_path_factory.mktemp("models")
    make_synthetic_dataset(data, n_timesteps=3)
    saved = (tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH,
             jenv.NERSEMBLE_DATA_PATH, jenv.NERSEMBLE_MODELS_PATH)
    tenv.NERSEMBLE_DATA_PATH = jenv.NERSEMBLE_DATA_PATH = str(data)
    tenv.NERSEMBLE_MODELS_PATH = jenv.NERSEMBLE_MODELS_PATH = str(models)
    try:
        result = tcli.main(SEQ + TINY + VARIANT + CPU + ["--name", "variant",
                                                         "--max-num-iterations", "8"])
        manager = NeRSembleModelFolder().new_run(name="jax")
        config = jcli.build_config(jcli.build_parser().parse_args(SEQ + TINY + VARIANT),
                                   manager.get_run_name(), str(models / "nersemble"))
        config.model.n_timesteps = config.data.n_timesteps = 3
        config.model.num_images = 36
        config.model.spherical_harmonics_degree = 4
        config.model.use_appearance_embedding = True
        manager.save_config(config)
        model = JModel(config.model)
        params = model.init_params(jax.random.PRNGKey(0))
        jckpt.save_checkpoint(Path(manager.get_checkpoint_folder()) / "step-000000003.ckpt",
                              3, params, make_optimizer().init(params),
                              model.init_grid_occs())
        yield {"root": models / "nersemble", "result": result}
    finally:
        (tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH,
         jenv.NERSEMBLE_DATA_PATH, jenv.NERSEMBLE_MODELS_PATH) = saved


def test_variant_flags_train_with_the_jax_config(variant_runs):
    """The train CLI with --no-use-hash-ensemble --cone-angle 0.004
    --early-stop-eps 1e-4 trains 8 steps on the CPU; its config.yml is the
    JAX CLI's config for the same flags with the capture's fields filled in
    (n_timesteps, num_images, scene_box), and the JAX package loads the
    run's checkpoint into its own parameter tree."""
    from nersemble_tpu.engine import checkpoints as jckpt
    from nersemble_tpu.engine.optimizers import make_optimizer
    from nersemble_tpu.model_manager import NeRSembleModelFolder
    from nersemble_tpu.models.nersemble import NeRSembleModel as JModel

    run_dir = variant_runs["root"] / "NERS-001-variant"
    result = variant_runs["result"]
    assert result["step"] == 7 and np.isfinite(result["loss"])
    metrics = _metrics(run_dir)
    assert np.isfinite([metrics[s]["train_loss"] for s in (0, 7)]).all()
    assert metrics[7]["train_loss"] < metrics[0]["train_loss"]

    theirs = NeRSembleModelFolder().open_run("NERS-001-variant").load_config()
    want = jcli.build_config(jcli.build_parser().parse_args(
        SEQ + TINY + VARIANT + ["--max-num-iterations", "8"]),
        "NERS-001-variant", str(variant_runs["root"]))
    want.model.n_timesteps = want.data.n_timesteps = 3
    want.model.num_images = 36
    want.model.scene_box = theirs.model.scene_box
    assert theirs.to_dict() == want.to_dict()
    assert not theirs.model.use_hash_ensemble and theirs.model.hash_ensemble is None
    assert (theirs.model.cone_angle, theirs.model.early_stop_eps) == (0.004, 1e-4)

    model = JModel(theirs.model)
    template = model.init_params(jax.random.PRNGKey(1))
    step, params, _, _, _ = jckpt.load_checkpoint(
        run_dir / "checkpoints" / "step-000000007.ckpt", template,
        make_optimizer().init(template), model.init_grid_occs())
    assert step == 7 and params["field"]["table"].shape[1] == 2


@pytest.mark.parametrize("run", ["NERS-001-variant", "NERS-002-jax"])
def test_variant_runs_evaluate_and_render(variant_runs, run, tmp_path):
    """The evaluate, render and view CLIs serve the port's variant run and
    the JAX-written one (single grid, cone angle, early stop, SH degree 4
    and the appearance embedding) on the CPU."""
    import socket
    import threading
    import time
    import urllib.error
    import urllib.request

    from nersemble_tpu_torch.scripts import evaluate_nersemble as teval
    from nersemble_tpu_torch.scripts import render_nersemble as trender
    from nersemble_tpu_torch.scripts import view_nersemble as tview
    from nersemble_tpu_torch.utils import jod as TJ
    from nersemble_tpu_torch.utils import png

    TJ.set_jod_evaluator_factory(_FakeJod)
    try:
        result = teval.main([run, "--max-eval-timesteps", "2", "--n-rays-eval", "512",
                             "--no-use-occupancy-grid-filtering"] + CPU)
    finally:
        TJ.set_jod_evaluator_factory(None)
    assert np.isfinite(result.mean.regular.psnr) and 0.0 <= result.mean.regular.ssim <= 1.0
    pngs = list((variant_runs["root"] / run / "evaluation").rglob("cam_*.png"))
    assert len(pngs) == 2 * 4
    outputs = trender.main([run, "--seconds", "1", "--fps", "2", "--downscale-factor", "8",
                            "--n-rays", "512", "--render-depth"] + CPU,
                           renders_path=str(tmp_path))
    assert set(outputs) == {"rgb", "depth"}
    for path in outputs.values():
        frames = sorted(Path(path).iterdir())
        assert len(frames) == 2 and png.imread(frames[0]).shape[2] == 3

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    replies = []

    def client():
        deadline = time.time() + 60
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/render?channel=rgb&width=40",
                        timeout=60) as r:
                    replies.append((r.status, r.read()))
                return
            except urllib.error.URLError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)

    thread = threading.Thread(target=client)
    thread.start()
    assert tview.main([run, "--port", str(port)] + CPU, max_requests=1) == 1
    thread.join(timeout=30)
    (status, payload), = replies
    assert status == 200 and png.decode(payload).shape[1:] == (40, 3)
