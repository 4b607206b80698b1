"""The live viewer and the serving CLIs over two gloo ranks (CPU tensors).

- ``--vis viewer`` with ``--data-axis-size 2``: rank 0 runs the server,
  a request queued during step 0 is served after it by both ranks
  (viewer/server.py ``serve_over_ranks``), and the frame equals one rank's
  within tests/test_torch_parallel_io.py's render bound (atol 5e-5, rtol
  1e-4). Both runs train at learning rate 0, so that the two hold the same
  parameters and the frames differ only by the render's sums (one Adam
  step moves an entry whose gradient is near 0 by the learning rate either
  way). A render that fails on one rank ends the run on both, it does not
  hang (``parallel/compare.viewer_run`` with a failing rank).
- The evaluate and render CLIs on a run whose config.yml says
  ``data_axis_size: 2`` start two ranks (ZeRO-3 table, each rank its share
  of every chunk) and one writer: the artifacts of a copy of the run that
  says 1, the PNGs within one 8-bit level (frames within the render bound)
  and the metrics within its rtol, each line of the CLI printed once; the
  view CLI on that run serves two requests over both ranks, then rank 0's
  stop message ends the other rank's loop.
"""

import contextlib
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from test_torch_cli import CPU, SEQ, TINY
from test_torch_parallel_io import RENDER_ATOL, RENDER_RTOL
from torch_parallel_parity import TIMEOUT_S

import nersemble_tpu_torch.env as tenv
from nersemble_tpu_torch.config import TrainConfig
from nersemble_tpu_torch.parallel import compare, launch
from nersemble_tpu_torch.scripts import evaluate_nersemble as teval
from nersemble_tpu_torch.scripts import render_nersemble as trender
from nersemble_tpu_torch.scripts import train_nersemble as tcli
from nersemble_tpu_torch.utils import png
from tests.synthetic_data import make_synthetic_dataset

TWO = ["--data-axis-size", "2", "--dist-backend", "gloo"]
FROZEN = ["--lr-main", "0", "--lr-deformation-field", "0", "--lr-embeddings", "0"]
EVAL = ["--max-eval-timesteps", "2", "--n-rays-eval", "512",
        "--no-use-occupancy-grid-filtering"] + CPU
RENDER = ["--seconds", "1", "--fps", "2", "--downscale-factor", "8", "--n-rays", "512",
          "--render-depth"] + CPU


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    data = tmp_path_factory.mktemp("data")
    models = tmp_path_factory.mktemp("models")
    renders = tmp_path_factory.mktemp("renders")
    make_synthetic_dataset(data, n_timesteps=3)
    saved = tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH, tenv.NERSEMBLE_RENDERS_PATH
    tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH = str(data), str(models)
    tenv.NERSEMBLE_RENDERS_PATH = str(renders)
    try:
        yield {"models": models / "nersemble", "renders": renders,
               "env": {name: getattr(tenv, name) for name in launch.ENV_ROOTS}}
    finally:
        tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH, \
            tenv.NERSEMBLE_RENDERS_PATH = saved


@contextlib.contextmanager
def _printed(path):
    """What this process and the ranks it starts print, into ``path``."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
        try:
            yield
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)


@pytest.fixture(scope="module")
def served(roots, tmp_path_factory):
    """A run trained over 2 ranks ("NERS-001-two", config data_axis_size 2)
    and a copy that says 1 ("NERS-002-one"); each evaluated and rendered;
    the CLIs' printed lines."""
    tmp = tmp_path_factory.mktemp("serve")
    tcli.main(SEQ + TINY + CPU + TWO + ["--name", "two", "--max-num-iterations", "3"])
    two = roots["models"] / "NERS-001-two"
    one = roots["models"] / "NERS-002-one"
    shutil.copytree(two, one)
    config = TrainConfig.load(one / "config.yml")
    assert config.parallel.data_axis_size == 2
    config.parallel.data_axis_size = 1
    config.save(one / "config.yml")
    out = {}
    for run in ("NERS-001-two", "NERS-002-one"):
        with _printed(tmp / f"{run}.log"):
            result = teval.main([run] + EVAL)
            renders = trender.main([run] + RENDER, renders_path=str(tmp / run))
        out[run] = {"result": result, "renders": renders,
                    "printed": (tmp / f"{run}.log").read_text()}
    return {"two": two, "one": one, "out": out}


def _pngs(folder):
    return {p.relative_to(folder): png.imread(p) for p in sorted(folder.rglob("*.png"))}


def test_evaluate_cli_over_two_ranks_has_one_writer_and_one_ranks_numbers(served):
    two, one = served["two"] / "evaluation", served["one"] / "evaluation"
    a, b = _pngs(two), _pngs(one)
    assert a.keys() == b.keys() and len(a) == 8  # 4 cameras x 2 timesteps
    for key in a:
        assert np.abs(a[key].astype(int) - b[key].astype(int)).max() <= 1, key
    written = [[json.loads(p.read_text()) for p in folder.rglob("evaluation_result.json")]
               for folder in (two, one)]
    ours, theirs = (served["out"][r]["result"].to_dict()
                    for r in ("NERS-001-two", "NERS-002-one"))
    assert written == [[ours], [theirs]]

    def numbers(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from numbers(v, path + (k,))
        elif tree is not None:
            yield path, tree

    ours, theirs = dict(numbers(ours)), dict(numbers(theirs))
    assert ours.keys() == theirs.keys() and any(k[-1] == "psnr" for k in ours)
    for key, value in theirs.items():
        assert abs(ours[key] - value) <= RENDER_RTOL * abs(value) + 1e-9, key
    printed = served["out"]["NERS-001-two"]["printed"]
    assert printed.count("[eval] mean psnr=") == 1
    assert printed.count("[eval] cam ") == 8


def test_render_cli_over_two_ranks_has_one_writer_and_one_ranks_frames(served):
    ours, theirs = (served["out"][r]["renders"] for r in ("NERS-001-two", "NERS-002-one"))
    assert ours.keys() == theirs.keys() == {"rgb", "depth"}
    for channel in ours:
        a, b = _pngs(Path(ours[channel])), _pngs(Path(theirs[channel]))
        assert a.keys() == b.keys() and len(a) == 2
        for key in a:
            assert np.abs(a[key].astype(int) - b[key].astype(int)).max() <= 1, key
    assert served["out"]["NERS-001-two"]["printed"].count("[render] wrote") == 2


def test_view_cli_over_two_ranks_serves_and_stops(served):
    """The view CLI on the run whose config says 2 ranks: rank 0's server
    answers two requests that both ranks render, then its stop message ends
    the other rank's loop and the CLI returns."""
    import socket
    import threading
    from nersemble_tpu_torch.scripts import view_nersemble as tview
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    replies = {}

    def client():
        for channel in ("rgb", "depth"):
            for _ in range(600):  # until the ranks have started the server
                try:
                    compare._fetch(f"http://127.0.0.1:{port}/render?channel={channel}"
                                   f"&width=40", replies.setdefault(channel, {}))
                    break
                except OSError:
                    time.sleep(0.1)

    thread = threading.Thread(target=client)
    thread.start()
    assert tview.main(["NERS-001-two", "--port", str(port)] + CPU, max_requests=2) == 2
    thread.join(timeout=60)
    for channel in ("rgb", "depth"):
        reply = replies[channel]
        assert (reply["status"], reply["ctype"]) == (200, "image/png"), channel
        assert png.decode(reply["body"]).shape[1:] == (40, 3)


def _viewer_spec(roots, tmp, name, ranks, **extra):
    argv = SEQ + TINY + CPU + FROZEN + [
        "--name", name, "--vis", "viewer", "--viewer-port", "0", "--max-num-iterations",
        "2", "--data-axis-size", str(ranks), "--dist-backend", "gloo"]
    return {"argv": argv, "roots": roots["env"], "out": str(tmp / f"{name}.npz"),
            "query": {"channel": "rgb", "width": 48, "az": 0.3}, **extra}


def test_viewer_over_two_ranks_serves_one_ranks_frame(roots, tmp_path):
    one = compare.viewer_run(None, _viewer_spec(roots, tmp_path, "view1", 1))
    (two,) = launch.spawn(compare.run_many, 2, "gloo", "cpu",
                          [("viewer_run", _viewer_spec(roots, tmp_path, "view2", 2))],
                          timeout_s=TIMEOUT_S)
    assert one["layout"] == "replicated" and two["layout"] == "zero3"
    for result in (one, two):
        assert result["status"] == 200 and result["ctype"] == "image/png"
        assert result["frames"] == 1 and result["step"] == 1
    a, b = np.load(tmp_path / "view2.npz"), np.load(tmp_path / "view1.npz")
    assert a["frame"].shape[1:] == (48, 3) and a["frame"].max() > 0
    np.testing.assert_allclose(a["frame"], b["frame"], atol=RENDER_ATOL, rtol=RENDER_RTOL)
    assert np.abs(a["png"].astype(int) - b["png"].astype(int)).max() <= 1


def test_a_failed_render_ends_the_run_on_every_rank(roots, tmp_path):
    """Rank 1's render raises: the run ends (rank 0 answers the request with
    a 500 and raises too, or the launcher stops it) instead of waiting in a
    collective."""
    spec = _viewer_spec(roots, tmp_path, "viewfail", 2, fail_rank=1)
    with pytest.raises(Exception, match="viewer render failed on rank"):
        launch.spawn(compare.run_many, 2, "gloo", "cpu", [("viewer_run", spec)],
                     timeout_s=TIMEOUT_S)
