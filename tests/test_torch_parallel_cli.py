"""The train CLI over two gloo ranks (CPU tensors):
``train_nersemble --data-axis-size 2 --dist-backend gloo --device cpu`` on
the synthetic capture trains, writes one run folder from rank 0 (config,
metrics, checkpoint of the gathered table) and resumes over two ranks bit
for bit; ``--vis viewer`` over two ranks trains while rank 0 serves the
viewer.
"""

import json

import numpy as np
import pytest
from test_torch_cli import CPU, LOG_KEYS, SEQ, TINY

import nersemble_tpu_torch.env as tenv
from nersemble_tpu_torch.engine.checkpoints import read_flat
from nersemble_tpu_torch.model_manager import NeRSembleModelFolder
from nersemble_tpu_torch.scripts import train_nersemble as tcli
from tests.synthetic_data import make_synthetic_dataset


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The train CLI over 2 ranks: "whole" (8 steps), "part" (5 steps, then
    resumed to 8 over 2 ranks)."""
    data = tmp_path_factory.mktemp("data")
    models = tmp_path_factory.mktemp("models")
    make_synthetic_dataset(data, n_timesteps=3)
    saved = tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH
    tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH = str(data), str(models)
    two = ["--data-axis-size", "2", "--dist-backend", "gloo"]
    try:
        results = {
            "whole": tcli.main(SEQ + TINY + CPU + two + [
                "--name", "whole", "--max-num-iterations", "8",
                "--steps-per-save", "6"]),
            "part": tcli.main(SEQ + TINY + CPU + two + [
                "--name", "part", "--max-num-iterations", "5"]),
        }
        results["resumed"] = tcli.main(SEQ + CPU + two + [
            "--resume-run", "NERS-002-part", "--max-num-iterations", "8"])
        yield {"root": models / "nersemble", "results": results}
    finally:
        tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH = saved


def test_train_cli_over_two_ranks(cli_runs):
    run_dir = cli_runs["root"] / "NERS-001-whole"
    assert {p.name for p in run_dir.iterdir()} == {
        "config.yml", "checkpoints", "metrics.jsonl", "dataparser_transforms.json"}
    assert [p.name for p in (run_dir / "checkpoints").iterdir()] == ["step-000000007.ckpt"]
    result = cli_runs["results"]["whole"]
    assert result["step"] == 7 and np.isfinite(result["loss"])
    steps = {}
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        record = json.loads(line)
        steps.setdefault(record.pop("step"), {}).update(record)
    assert LOG_KEYS <= set(steps[0]) and LOG_KEYS <= set(steps[7])
    config = NeRSembleModelFolder(str(cli_runs["root"].parent)).open_run(
        "NERS-001-whole").load_config()
    assert config.parallel.data_axis_size == 2
    flat = read_flat(run_dir / "checkpoints" / "step-000000007.ckpt")
    assert np.isfinite(flat["params/field/table"]).all()


def test_train_cli_resumes_over_two_ranks(cli_runs):
    root = cli_runs["root"]
    whole = read_flat(root / "NERS-001-whole" / "checkpoints" / "step-000000007.ckpt")
    resumed = read_flat(root / "NERS-002-part" / "checkpoints" / "step-000000007.ckpt")
    assert cli_runs["results"]["resumed"]["step"] == 7
    for key, value in whole.items():
        np.testing.assert_array_equal(resumed[key], value, err_msg=key)


def test_viewer_over_two_ranks_is_not_ported(cli_runs):
    """The name is the one this test had while ``--vis viewer`` over several
    ranks raised NotImplementedError; it now holds that such a run trains,
    writes its csv metrics from rank 0 and saves its gathered checkpoint
    (tests/test_torch_parallel_serve.py holds the served frame to one
    rank's)."""
    result = tcli.main(SEQ + TINY + CPU + ["--data-axis-size", "2", "--vis", "viewer",
                                           "--viewer-port", "0", "--name", "live",
                                           "--max-num-iterations", "2"])
    assert result["step"] == 1 and np.isfinite(result["loss"])
    (run_dir,) = cli_runs["root"].glob("NERS-*-live")
    assert (run_dir / "metrics.jsonl").exists()
    assert [p.name for p in (run_dir / "checkpoints").iterdir()] == ["step-000000001.ckpt"]
