"""The port's live viewer against the JAX package's: the orbit pose (to
1e-12), the PNG payload, the HTTP round trip with its error path
(tests/test_viewer.py's), the view CLI serving three requests from a thread,
and ``--vis viewer`` training two steps while it serves one request."""

import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import nersemble_tpu_torch.env as tenv
from nersemble_tpu.scripts import view_nersemble as jview
from nersemble_tpu.viewer import orbit_pose as jax_orbit_pose
from nersemble_tpu_torch.data.cameras import circle_around_axis
from nersemble_tpu_torch.scripts import train_nersemble as tcli
from nersemble_tpu_torch.scripts import view_nersemble as tview
from nersemble_tpu_torch.utils import png
from nersemble_tpu_torch.viewer import ViewerServer, encode_image, orbit_pose
from tests.synthetic_data import make_synthetic_dataset
from tests.test_torch_cli import CPU, SEQ, TINY


def test_orbit_pose_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(16):
        az, el = rng.uniform(0, 2 * np.pi), rng.uniform(-1.6, 1.6)
        dist = rng.uniform(0.05, 3.0)
        center = rng.normal(size=3)
        np.testing.assert_allclose(orbit_pose(az, el, dist, center=center),
                                   jax_orbit_pose(az, el, dist, center=center),
                                   rtol=0, atol=1e-12)


def test_orbit_pose_reproduces_the_circle_trajectory():
    ref = circle_around_axis(8, axis=(0, 1, 0), up=(0, 0, 1),
                             move=(0, -1, 0), distance=0.3)
    for i in (0, 1, 3, 4, 5, 7):  # 2 and 6 look along +-up: degenerate there
        np.testing.assert_allclose(orbit_pose(2 * np.pi * i / 8, 0.0, 0.3),
                                   ref[i], atol=1e-12)


def test_encode_image_is_a_png_of_the_frame():
    img = np.zeros((24, 32, 3), np.uint8)
    img[:, :16] = (255, 0, 0)
    img[5, 7] = (1, 2, 3)
    payload, ctype = encode_image(img)
    assert ctype == "image/png"
    np.testing.assert_array_equal(png.decode(payload), img)


def _fetch(url, results, key, retry_s=0.0):
    """GET ``url`` into ``results[key]`` as (status, body, content type),
    retrying refused connections for ``retry_s`` seconds."""
    deadline = time.time() + retry_s
    while True:
        try:
            with urllib.request.urlopen(url, timeout=60) as r:
                results[key] = (r.status, r.read(), r.headers["Content-Type"])
            return
        except urllib.error.HTTPError as e:
            results[key] = (e.code, e.read(), "")
            return
        except urllib.error.URLError:
            if time.time() > deadline:
                raise
            time.sleep(0.05)


def test_server_render_roundtrip_and_error_path():
    server = ViewerServer(state={"run_name": "t", "n_timesteps": 3,
                                 "step": 7, "distance": 0.3}, port=0)
    try:
        html = urllib.request.urlopen(server.url, timeout=10).read().decode()
        assert "<html" in html and '"n_timesteps": 3' in html
        seen, results = {}, {}

        def render(params):
            seen.update(params)
            h = max(16, round(params["width"] * 3 / 4))
            return np.full((h, params["width"], 3), 0.5, np.float32)

        t = threading.Thread(target=_fetch, args=(
            server.url + "render?az=1.5&el=0.2&dist=0.5&t=0.5&channel=depth&width=64",
            results, "ok"))
        t.start()
        for _ in range(200):  # this thread services the queue
            if server.service(render, timeout=0.05):
                break
        t.join(timeout=10)
        status, payload, ctype = results["ok"]
        assert status == 200 and ctype == "image/png"
        frame = png.decode(payload)
        assert frame.shape == (48, 64, 3) and (frame == 127).all()
        assert seen["az"] == 1.5 and seen["channel"] == "depth" and seen["width"] == 64

        # a raising callback surfaces a 500 and keeps the server alive
        t2 = threading.Thread(target=_fetch, args=(server.url + "render?width=32",
                                                   results, "err"))
        t2.start()
        for _ in range(200):
            if server.service(lambda p: (_ for _ in ()).throw(
                    RuntimeError("boom")), timeout=0.05):
                break
        t2.join(timeout=10)
        assert results["err"][0] == 500 and b"boom" in results["err"][1]

        t3 = threading.Thread(target=_fetch, args=(server.url + "render?width=nan",
                                                   results, "bad"))
        t3.start()
        t3.join(timeout=10)
        assert results["bad"][0] == 400
    finally:
        server.close()


def test_view_cli_flags_and_defaults_match():
    ours = {a.dest: a.default for a in tview.build_parser()._actions}
    theirs = {a.dest: a.default for a in jview.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"} and ours["device"] == "cuda"
    assert {k: ours[k] for k in theirs} == theirs


@pytest.fixture(scope="module")
def viewer_run(tmp_path_factory):
    """A tiny capture; its run "NERS-001-live" trained for 2 steps with
    ``--vis viewer`` while a thread asked the viewer for one frame."""
    data = tmp_path_factory.mktemp("data")
    models = tmp_path_factory.mktemp("models")
    make_synthetic_dataset(data, n_timesteps=3)
    saved = (tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH)
    tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH = str(data), str(models)
    served, steps, threads = {}, [], []

    def hook(trainer, step, phase):
        steps.append((step, phase, trainer.viewer.state["step"]))
        if (step, phase) == (0, "begin"):
            url = trainer.viewer.url + "render?channel=rgb&width=48&az=0.3"
            threads.append(threading.Thread(target=_fetch, args=(url, served, "rgb")))
            threads[0].start()
            deadline = time.time() + 30
            while trainer.viewer._queue.empty() and time.time() < deadline:
                time.sleep(0.01)
            served["url"] = trainer.viewer.url

    try:
        result = tcli.main(SEQ + TINY + CPU + ["--name", "live", "--vis", "viewer",
                                               "--viewer-port", "0",
                                               "--max-num-iterations", "2"],
                           step_hook=hook)
        threads[0].join(timeout=30)
        yield {"root": models / "nersemble", "result": result, "served": served,
               "steps": steps}
    finally:
        tenv.NERSEMBLE_DATA_PATH, tenv.NERSEMBLE_MODELS_PATH = saved


def test_vis_viewer_trains_and_serves_between_steps(viewer_run):
    assert viewer_run["result"]["step"] == 1 and np.isfinite(viewer_run["result"]["loss"])
    assert viewer_run["steps"] == [(0, "begin", 0), (0, "end", 0),
                                   (1, "begin", 0), (1, "end", 1)]
    status, payload, ctype = viewer_run["served"]["rgb"]
    assert status == 200 and ctype == "image/png"
    frame = png.decode(payload)
    assert frame.shape[1:] == (48, 3) and frame.shape[0] >= 16
    run_dir = viewer_run["root"] / "NERS-001-live"
    assert (run_dir / "metrics.jsonl").exists()  # csv metrics beside the viewer
    assert (run_dir / "checkpoints" / "step-000000001.ckpt").exists()
    with pytest.raises(urllib.error.URLError):  # the CLI closed the server
        urllib.request.urlopen(viewer_run["served"]["url"], timeout=5)


def test_view_cli_serves_three_channels(viewer_run):
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    results = {}

    def client():
        for channel in ("rgb", "depth", "deformation"):
            _fetch(f"http://127.0.0.1:{port}/render?channel={channel}&width=40&t=1",
                   results, channel, retry_s=60)

    thread = threading.Thread(target=client)
    thread.start()
    served = tview.main(["NERS-001-live", "--port", str(port)] + CPU, max_requests=3)
    thread.join(timeout=30)
    assert served == 3 and not thread.is_alive()
    frames = {}
    for channel in ("rgb", "depth", "deformation"):
        status, payload, ctype = results[channel]
        assert status == 200 and ctype == "image/png", (channel, payload[:200])
        frames[channel] = png.decode(payload)
        assert frames[channel].shape[1:] == (40, 3)
    assert len({f.shape for f in frames.values()}) == 1
