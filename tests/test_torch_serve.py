"""Serving a trained run: the port against the JAX package.

The occupancy CC filter (equal masks, the warning when it keeps nothing),
the render CLI's orbit (to 1e-12), the vendored FovVideoVDP JOD (rel 1e-6),
the JOD plumbing with a fake evaluator injected in both packages, LPIPS on
synthetic VGG-16-shaped weights (rel 1e-4), the auto render budget and the
viewer's frame on one tiny f32 checkpoint the JAX package wrote (to
test_torch_render.py's TOL, rtol 1e-4 / atol 1e-5, with the same probed and
grown budgets), and the evaluate and render CLIs on tiny runs either
package wrote.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_numpy_tree

import nersemble_tpu.env as jenv
import nersemble_tpu_torch.config as tcfg
import nersemble_tpu_torch.env as tenv
from nersemble_tpu.data import cameras as JCAM
from nersemble_tpu.scripts import evaluate_nersemble as jeval
from nersemble_tpu.scripts import render_nersemble as jrender
from nersemble_tpu.scripts import train_nersemble as jcli
from nersemble_tpu.utils import connected_components as JCC
from nersemble_tpu.utils import fvvdp as JF
from nersemble_tpu.utils import jod as JJ
from nersemble_tpu.utils import lpips as JL
from nersemble_tpu_torch.constants import EVALUATION_CAM_IDS, SERIALS
from nersemble_tpu_torch.data import cameras as TCAM
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.scripts import evaluate_nersemble as teval
from nersemble_tpu_torch.scripts import render_nersemble as trender
from nersemble_tpu_torch.scripts import train_nersemble as tcli
from nersemble_tpu_torch.scripts import view_nersemble as tview
from nersemble_tpu_torch.utils import connected_components as TCC
from nersemble_tpu_torch.utils import fvvdp as TF
from nersemble_tpu_torch.utils import jod as TJ
from nersemble_tpu_torch.utils import lpips as TL
from nersemble_tpu_torch.utils import metrics as TM
from nersemble_tpu_torch.utils import png
from nersemble_tpu_torch.utils.cameras import CONTRAST_SCALES, synthetic_occupancy
from tests.synthetic_data import make_synthetic_dataset
from tests.test_torch_cli import CPU, SEQ, TINY

TOL = dict(rtol=1e-4, atol=1e-5)  # test_torch_render.py's
CHUNK = 1024
KEYS = ("rgb", "depth", "accumulation", "deformation")


# ---------------------------------------------------------------------------
# host-side modules
# ---------------------------------------------------------------------------

def _densities(case: str) -> np.ndarray:
    """[24^3] EMA densities: two blobs and scattered floaters, or a grid too
    faint for the 0.05 threshold (an under-trained run)."""
    rng = np.random.default_rng(0)
    g = 24
    if case == "faint":
        return rng.uniform(0.0, 0.05, g ** 3).astype(np.float32)
    z, y, x = np.meshgrid(*(np.arange(g),) * 3, indexing="ij")
    grid = rng.uniform(0.0, 0.02, (g, g, g))
    grid[(z - 12) ** 2 + (y - 11) ** 2 + (x - 12) ** 2 < 36] = 4.0
    grid[(z - 4) ** 2 + (y - 19) ** 2 + (x - 5) ** 2 < 5] = 2.0
    grid[rng.uniform(size=(g, g, g)) < 0.01] = 3.0
    return grid.reshape(-1).astype(np.float32)


@pytest.mark.parametrize("case", ["blobs", "faint"])
def test_occupancy_filter_matches_jax(case, capsys):
    grid = _densities(case)
    ours = TCC.filter_occupancy_grid_mask(grid, 24, threshold=0.05, sigma_erosion=7)
    ours_err = capsys.readouterr().err
    theirs = JCC.filter_occupancy_grid_mask(grid, 24, threshold=0.05, sigma_erosion=7)
    theirs_err = capsys.readouterr().err
    assert ours.dtype == theirs.dtype == bool and ours.shape == (24, 24, 24)
    np.testing.assert_array_equal(ours, theirs)
    assert ("kept 0 cells" in ours_err) == ("kept 0 cells" in theirs_err) \
        == (case == "faint")
    assert ours.any() == (case == "blobs")
    for k in (1, 2):
        a = TCC.extract_top_k_connected_component(grid.reshape(24, 24, 24), k=k,
                                                  threshold=0.05)
        b = JCC.extract_top_k_connected_component(grid.reshape(24, 24, 24), k=k,
                                                  threshold=0.05)
        assert len(a) == len(b) == k
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("args", [(7, (0, 1, 0), (0, 0, 1), (0, -1, 0), 0.3),
                                  (5, (0.2, 1.0, 0.1), (0, 0, 1), (0.1, -1.0, 0.3), 1.7)])
def test_circle_around_axis_matches_jax(args):
    np.testing.assert_allclose(TCAM.circle_around_axis(*args),
                               JCAM.circle_around_axis(*args), rtol=0, atol=1e-12)


def _stacks(frames: int, seed: int):
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 256, (frames, 40, 52, 3)).astype(np.uint8)
    noise = rng.normal(0, 12, gt.shape)
    return np.clip(gt + noise, 0, 255).astype(np.uint8), gt


@pytest.mark.parametrize("frames", [1, 3, 5])
def test_vendored_jod_matches_jax(frames):
    pred, gt = _stacks(frames, frames)
    ours, _ = TF.VendoredFovVideoVDP().predict(pred, gt, dim_order="FHWC",
                                               frames_per_second=12.0)
    theirs, _ = JF.VendoredFovVideoVDP().predict(pred, gt, dim_order="FHWC",
                                                 frames_per_second=12.0)
    assert float(ours) == pytest.approx(float(theirs), rel=1e-6)
    assert 0.0 < float(ours) < 10.0
    same, _ = TF.VendoredFovVideoVDP().predict(gt, gt, dim_order="FHWC",
                                               frames_per_second=12.0)
    assert float(same) == pytest.approx(10.0)


@pytest.mark.parametrize("args", [(1, 15, 15, None), (2, 30, 15, None),
                                  (1, 16, 4, None), (3, 10, 0, 2), (1, 10, 5, 1),
                                  (1, 0, 15, None)])
def test_evaluation_fps_matches_jax(args):
    assert TJ.evaluation_fps(*args) == JJ.evaluation_fps(*args)


class FakeJod:
    """An injected evaluator: records what it was given."""

    def __init__(self):
        self.calls = []

    def predict(self, pred, gt, dim_order, frames_per_second):
        assert dim_order == "FHWC" and pred.dtype == np.uint8
        assert pred.shape == gt.shape and pred.ndim == 4
        self.calls.append(frames_per_second)
        return np.float32(8.5), None


@pytest.mark.parametrize("fps", [2.0, 24.0])
def test_jod_score_and_resolution_match_jax(fps, monkeypatch):
    pred, gt = _stacks(2, 9)
    scores, seen = [], []
    for module in (TJ, JJ):
        module.set_jod_evaluator_factory(FakeJod)
        try:
            evaluator = module.get_jod_evaluator()
            assert module.get_jod_evaluator() is evaluator  # cached
            scores.append(module.jod_score(evaluator, pred, gt, fps))
            seen.append(evaluator.calls)
        finally:
            module.set_jod_evaluator_factory(None)
    assert scores == [8.5, 8.5] and seen[0] == seen[1] == [max(4.1, fps)]
    # without pyfvvdp: the vendored pipeline, unless it is switched off
    assert type(TJ.get_jod_evaluator()).__name__ == type(JJ.get_jod_evaluator()).__name__ \
        == "VendoredFovVideoVDP"
    monkeypatch.setenv("NERSEMBLE_DISABLE_VENDORED_JOD", "1")
    for module in (TJ, JJ):
        module.set_jod_evaluator_factory(None)
        assert module.get_jod_evaluator() is None
    monkeypatch.delenv("NERSEMBLE_DISABLE_VENDORED_JOD")
    for module in (TJ, JJ):
        module.set_jod_evaluator_factory(None)


def _synthetic_vgg_weights(rng):
    """Random VGG-16-shaped conv weights + LPIPS linear heads (small scale so
    activations stay finite), as tests/test_metrics_golden.py builds them."""
    convs = {0: (64, 3), 2: (64, 64), 5: (128, 64), 7: (128, 128),
             10: (256, 128), 12: (256, 256), 14: (256, 256),
             17: (512, 256), 19: (512, 512), 21: (512, 512),
             24: (512, 512), 26: (512, 512), 28: (512, 512)}
    weights = {}
    for i, (o, c) in convs.items():
        weights[f"features.{i}.weight"] = \
            rng.normal(0, 0.05, (o, c, 3, 3)).astype(np.float32)
        weights[f"features.{i}.bias"] = \
            rng.normal(0, 0.01, (o,)).astype(np.float32)
    for k, c in enumerate((64, 128, 256, 512, 512)):
        weights[f"lin{k}.model.1.weight"] = \
            rng.uniform(0, 0.1, (1, c, 1, 1)).astype(np.float32)
    return weights


@pytest.fixture
def lpips_weights(tmp_path, monkeypatch):
    path = tmp_path / "vgg.npz"
    np.savez(path, **_synthetic_vgg_weights(np.random.default_rng(0)))
    monkeypatch.setenv("NERSEMBLE_LPIPS_WEIGHTS", str(path))
    TL.reset_lpips_cache()
    JL.reset_lpips_cache()
    yield path
    TL.reset_lpips_cache()
    JL.reset_lpips_cache()


@pytest.mark.parametrize("shape", [(64, 64, 3), (45, 38, 3)])
def test_lpips_matches_jax(lpips_weights, shape):
    """Rel 1e-4: float32 convolutions summed in other orders through 13
    layers; odd sizes take max_pool2d's floor like reduce_window VALID."""
    rng = np.random.default_rng(1)
    pred = rng.uniform(size=shape).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    assert TL.lpips_available()
    ours = TL.lpips_or_none(pred, target, "cpu")
    theirs = JL.lpips_or_none(pred, target)
    assert ours > 0 and ours == pytest.approx(theirs, rel=1e-4)
    assert TL.lpips_or_none(pred, pred, "cpu") == 0.0
    regular, masked = TM.image_metrics(pred, target, None, "cpu")
    assert regular["lpips"] == ours and masked["lpips"] is None


# ---------------------------------------------------------------------------
# a tiny f32 run the JAX package wrote, served by both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Paths of a tiny capture and of two runs: "NERS-001-smoke" (8 steps of
    the port's train CLI) and "NERS-002-jax" (config.yml and a step-5
    checkpoint written by the JAX package: f32 tables and compute, every
    sample slot evaluated, contrast-scaled parameters, a 5% grid plus its
    centre block), and the eval-only trainers of the JAX run in both
    packages."""
    from nersemble_tpu.engine import checkpoints as jckpt
    from nersemble_tpu.engine.optimizers import make_optimizer
    from nersemble_tpu.engine.trainer import NeRSembleTrainer as JTrainer
    from nersemble_tpu.model_manager import NeRSembleModelFolder
    from nersemble_tpu.models.nersemble import NeRSembleModel as JModel

    data = tmp_path_factory.mktemp("data")
    models = tmp_path_factory.mktemp("models")
    make_synthetic_dataset(data, n_timesteps=3)
    saved = (tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH,
             jenv.NERSEMBLE_DATA_PATH, jenv.NERSEMBLE_MODELS_PATH)
    tenv.NERSEMBLE_DATA_PATH = jenv.NERSEMBLE_DATA_PATH = str(data)
    tenv.NERSEMBLE_MODELS_PATH = jenv.NERSEMBLE_MODELS_PATH = str(models)
    jt = None
    try:
        tcli.main(SEQ + TINY + CPU + ["--name", "smoke", "--max-num-iterations", "8"])

        manager = NeRSembleModelFolder().new_run(name="jax")
        config = jcli.build_config(jcli.build_parser().parse_args(SEQ + TINY),
                                   manager.get_run_name(), str(models / "nersemble"))
        config.model.n_timesteps = config.data.n_timesteps = 3
        config.model.num_images = 36
        config.model.compute_dtype = config.model.table_dtype = "float32"
        config.model.sampling.global_budget_fraction = 1.0
        manager.save_config(config)
        model = JModel(config.model)
        params = to_numpy_tree(model.init_params(jax.random.PRNGKey(0)))
        for key, factor in CONTRAST_SCALES.items():
            *path, leaf = key.split(".")
            node = params
            for part in path:
                node = node[part]
            node[leaf] = node[leaf] * factor
        params = jax.tree_util.tree_map(jnp.asarray, params)
        jckpt.save_checkpoint(
            Path(manager.get_checkpoint_folder()) / "step-000000005.ckpt", 5,
            params, make_optimizer().init(params),
            jnp.asarray(synthetic_occupancy(16, 0.05, seed=0)),
            extra={"sample_budget": np.asarray(4096)})

        jconfig = manager.load_config()
        jconfig.load_dir, jconfig.vis = manager.get_checkpoint_folder(), "none"
        jt = JTrainer(jconfig, model_manager=manager, eval_only=True)
        tconfig = tcfg.TrainConfig.load(Path(manager.get_location()) / "config.yml")
        tconfig.load_dir, tconfig.vis = manager.get_checkpoint_folder(), "none"
        tt = NeRSembleTrainer.from_train_config(tconfig, eval_only=True, device="cpu")
        yield {"data": data, "root": models / "nersemble", "jax": jt, "torch": tt}
    finally:
        if jt is not None:
            jt.batcher.stop()
        (tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH,
         jenv.NERSEMBLE_DATA_PATH, jenv.NERSEMBLE_MODELS_PATH) = saved


def _eval_view(served, idx=0):
    jrays = served["jax"].eval_loader.image_rays(idx)
    trays = served["torch"].eval_loader.image_rays(idx)
    for key in ("origins", "directions", "timesteps"):
        np.testing.assert_array_equal(trays[key], jrays[key])
    return jrays, trays


def test_auto_budget_matches_none_and_jax(served):
    """The probe sets the same budget in both packages; the auto render
    equals the port's budget=None render and the JAX auto render."""
    jt, tt = served["jax"], served["torch"]
    step = tt.start_step - 1
    assert step == jt.start_step - 1 == 5
    jrays, trays = _eval_view(served)
    assert tt.renderer().auto_budget is None
    auto = tt.render_image(trays, step, chunk=CHUNK, budget="auto")
    probed = tt.renderer().auto_budget
    plain = tt.render_image(trays, step, chunk=CHUNK)
    theirs = jt.render_image(jrays, step, chunk=CHUNK, budget="auto")
    assert probed == jt._auto_render_budget
    assert 8192 <= probed < CHUNK * tt.config.sampling.max_samples_per_ray
    assert auto["accumulation"].max() > 0.05
    for key in KEYS:
        np.testing.assert_allclose(auto[key], plain[key], **TOL, err_msg=key)
        np.testing.assert_allclose(auto[key], theirs[key], **TOL, err_msg=key)
    # a second frame reuses the probed budget
    again = tt.render_image(trays, step, chunk=CHUNK, budget="auto")
    assert tt.renderer().auto_budget == probed
    np.testing.assert_array_equal(again["rgb"], auto["rgb"])


def test_viewer_render_matches_jax(served):
    """The live viewer's frame (auto budget, the run's eval chunk) and its
    depth and deformation colormaps."""
    jt, tt = served["jax"], served["torch"]
    for channel in ("rgb", "depth", "deformation"):
        params = {"az": 0.4, "el": 0.2, "dist": 0.35, "t": 0.5,
                  "channel": channel, "width": 40}
        ours = np.asarray(tt.viewer_render(params, 5))
        theirs = np.asarray(jt.viewer_render(params, 5))
        assert ours.shape == theirs.shape and ours.shape[1:] == (40, 3)
        np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4, err_msg=channel)
    assert tt.renderer().auto_budget == jt._auto_render_budget


def test_jax_checkpoint_evaluates_in_the_port(served):
    """The port's evaluate CLI on the JAX run, without the filter: its PNGs
    are the JAX trainer's renders to one 8-bit level; the vendored JOD."""
    jt = served["jax"]
    result = teval.main(["NERS-002-jax", "--max-eval-timesteps", "2",
                         "--n-rays-eval", str(CHUNK),
                         "--no-use-occupancy-grid-filtering"] + CPU)
    folder = served["root"] / "NERS-002-jax" / "evaluation" / \
        "checkpoint_5_max_eval_timesteps_2_no-occupancy-grid-filtering"
    assert len(list(folder.rglob("cam_*.png"))) == 8
    jrays, _ = _eval_view(served, 1)
    entry = jrays["entry"]
    ours = png.imread(folder / f"frame_{entry.original_timestep:05d}"
                      / f"cam_{entry.cam_id}.png").astype(np.int64)
    theirs = (np.clip(jt.render_image(jrays, 5, chunk=CHUNK)["rgb"], 0, 1) * 255).round()
    assert np.abs(ours - theirs).max() <= 1
    for bundle in (result.mean.regular, result.mean.masked):
        assert np.isfinite(bundle.psnr) and 0.0 <= bundle.ssim <= 1.0
        assert 0.0 <= bundle.jod <= 10.0 and bundle.lpips is None


def test_overflow_rerenders_and_grows_the_budget_as_in_jax(served):
    """A budget of 8192 cached for a denser view (every cell occupied):
    every chunk drops samples, is rendered again with budget=None, and the
    budget grows to cover it, in both packages."""
    jt, tt = served["jax"], served["torch"]
    jrays, trays = _eval_view(served)
    saved = jt.grid_occs, tt.grid_occs
    dense = np.ones(16 ** 3, np.float32)
    try:
        jt.grid_occs, tt.grid_occs = jnp.asarray(dense), torch.from_numpy(dense)
        tt._renderer = None
        jt._auto_render_budget = tt.renderer().auto_budget = 8192
        ours = tt.render_image(trays, 5, chunk=CHUNK, budget="auto")
        theirs = jt.render_image(jrays, 5, chunk=CHUNK, budget="auto")
        grown = tt.renderer().auto_budget
        assert grown == jt._auto_render_budget and grown > 8192
        plain = tt.render_image(trays, 5, chunk=CHUNK)
        for key in KEYS:
            np.testing.assert_allclose(ours[key], theirs[key], **TOL, err_msg=key)
            np.testing.assert_allclose(ours[key], plain[key], **TOL, err_msg=key)
    finally:
        jt.grid_occs, tt.grid_occs = saved
        tt._renderer = None


def test_apply_grid_mask_makes_a_new_mask_and_drops_the_renderer(served):
    tt = served["torch"]
    renderer = tt.renderer()
    renderer.auto_budget = 16384
    before = tt.grid_mask
    mask = np.zeros((16, 16, 16), bool)
    mask[4:12, 4:12, 4:12] = True
    try:
        tt.apply_grid_mask(mask)
        assert tt.grid_mask is not before and tt.renderer() is not renderer
        assert tt.renderer().auto_budget is None
        expected = torch.from_numpy(mask) if before is None else before & torch.from_numpy(mask)
        assert torch.equal(tt.grid_mask, expected)
    finally:
        tt.grid_mask, tt._renderer = before, None


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ours,theirs", [(teval, jeval), (trender, jrender)],
                         ids=["evaluate", "render"])
def test_cli_flags_and_defaults_match(ours, theirs):
    a = {x.dest: x.default for x in ours.build_parser()._actions}
    b = {x.dest: x.default for x in theirs.build_parser()._actions}
    assert set(a) - set(b) == {"device"} and a["device"] == "cuda"
    assert {k: a[k] for k in b} == b


def test_evaluate_cli_artifacts_read_by_the_jax_package(served):
    from nersemble_tpu.model_manager import NeRSembleModelFolder

    TJ.set_jod_evaluator_factory(FakeJod)
    try:
        result = teval.main(["NERS-001-smoke", "--max-eval-timesteps", "2",
                             "--n-rays-eval", "512"] + CPU)
    finally:
        TJ.set_jod_evaluator_factory(None)
    run_dir = served["root"] / "NERS-001-smoke"
    pngs = list((run_dir / "evaluation").rglob("cam_*.png"))
    assert {p.parent.name + "/" + p.name for p in pngs} == \
        {f"frame_{t:05d}/cam_{c}.png" for t in (0, 2) for c in EVALUATION_CAM_IDS}
    assert all(png.imread(p).shape[2] == 3 for p in pngs)
    files = list((run_dir / "evaluation").rglob("evaluation_result.json"))
    assert [f.parent.name for f in files] == ["checkpoint_7_max_eval_timesteps_2"]
    data = json.loads(files[0].read_text())
    assert set(data["per_cam"]) == {SERIALS[c] for c in EVALUATION_CAM_IDS}
    assert result.mean.regular.jod == pytest.approx(8.5)
    assert result.mean.masked.jod == pytest.approx(8.5)
    assert np.isfinite(result.mean.regular.psnr) and np.isfinite(result.mean.masked.psnr)
    theirs = NeRSembleModelFolder().open_run("NERS-001-smoke").load_evaluation_result(
        7, max_eval_timesteps=2)
    assert theirs.to_dict() == result.to_dict()


def test_render_cli_writes_the_jax_fallback_layout(served, tmp_path):
    outputs = trender.main(["NERS-001-smoke", "--seconds", "1", "--fps", "3",
                            "--downscale-factor", "8", "--n-rays", "512",
                            "--render-depth", "--render-deformations"] + CPU,
                           renders_path=str(tmp_path))
    assert set(outputs) == {"rgb", "depth", "deformation"}
    shapes = set()
    for channel, path in outputs.items():
        assert Path(path) == tmp_path / f"NERS-001-smoke_{channel}_checkpoint-7"
        frames = sorted(Path(path).iterdir())
        assert [f.name for f in frames] == [f"frame_{i:05d}.png" for i in range(3)]
        shapes |= {png.imread(f).shape for f in frames}
    (h, w, c), = shapes
    assert c == 3 and 0 < h and 0 < w


def test_write_video_matches_the_jax_fallback(tmp_path, monkeypatch):
    """Without a video encoder the JAX package writes PNG frames; the port
    always does, with the same names and pixels."""
    import sys

    import imageio.v3 as iio

    from nersemble_tpu.utils import videoio as JV
    from nersemble_tpu_torch.utils import videoio as TV
    monkeypatch.setitem(sys.modules, "cv2", None)
    rng = np.random.default_rng(3)
    frames = [rng.uniform(-0.1, 1.1, (9, 13, 3)).astype(np.float32),
              rng.integers(0, 256, (9, 13, 3)).astype(np.uint8)]
    ours = Path(TV.write_video(tmp_path / "ours" / "run_rgb.mp4", frames))
    theirs = Path(JV.write_video(tmp_path / "theirs" / "run_rgb.mp4", frames))
    assert ours.name == theirs.name == "run_rgb"
    names = sorted(p.name for p in theirs.iterdir())
    assert sorted(p.name for p in ours.iterdir()) == names == ["frame_00000.png",
                                                               "frame_00001.png"]
    for name in names:
        np.testing.assert_array_equal(png.imread(ours / name), iio.imread(theirs / name))


def test_serving_clis_need_cuda_unless_asked_for_the_cpu(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = sorted(p.name for p in (served["root"] / "NERS-001-smoke").iterdir())
    for main in (teval.main, trender.main, tview.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["NERS-001-smoke"])
    assert sorted(p.name for p in (served["root"] / "NERS-001-smoke").iterdir()) == before
