"""The port's tracer (``nersemble_tpu_torch/utils/spans.py``) on the CPU at
the tiny flagship size: off it records nothing and changes no bit of a
step; on it records every span of the loop with its step, nested on the
host clock, the backward's spans under ``train:backward``, the host reads
at their sites and the launches of each span; device times on the host
clock; the idle gaps of a profiled segment by span; the train CLI's
profiled segment written with its spans."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from chip_smoke import tiny_config
from nersemble_tpu_torch.data.ray_batcher import DeviceBatches
from nersemble_tpu_torch.engine.trainer import NeRSembleTrainer
from nersemble_tpu_torch.engine.writer import MetricsWriter
from nersemble_tpu_torch.ops import launch_counts, quad_kernel
from nersemble_tpu_torch.utils import spans

# the spans of a step on one device (train:reduce needs a mesh; render:sigma_probe
# is the eval render's)
STEP_SPANS = {"loop:step", "loop:batch_wait", "loop:batch_copy", "data:build",
              "loop:occupancy", "loop:budget", "train:forward", "train:backward",
              "train:adam", "render:march", "render:field", "encode:quad_build",
              "encode:fwd", "bwd:hash_encode", "bwd:quad_fold", "bwd:fused_mlp",
              "bwd:time_code"}


@pytest.fixture(autouse=True)
def fresh_tracer():
    spans.reset()
    yield
    spans.reset()


def _batch(cfg, n=64, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)) * [0.05, 0.3, 0.3] + [1.0, 0.0, 0.0]
    return {"origins": np.tile(np.float32([[-8.0, 0.0, 0.0]]), (n, 1)),
            "directions": (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32),
            "timesteps": rng.integers(0, cfg.n_timesteps, n),
            "camera_indices": rng.integers(0, max(cfg.num_images, 1), n),
            "rgb": rng.uniform(size=(n, 3)).astype(np.float32),
            "alpha": rng.uniform(size=n).astype(np.float32),
            "depth": rng.uniform(7.5, 9.5, n).astype(np.float32)}


class _Batcher:
    """``batch_for_step`` of a fixed batch per step."""

    def __init__(self, cfg):
        self.cfg = cfg

    def batch_for_step(self, step):
        return _batch(self.cfg, seed=step)


def _train(steps=(0, 1)):
    """A tiny trainer's steps through ``DeviceBatches`` and ``run_step``:
    (losses, parameters)."""
    cfg, params = tiny_config(None)
    trainer = NeRSembleTrainer(cfg, n_rays=64, device="cpu", params=params)
    batches = DeviceBatches(_Batcher(cfg), steps[0], "cpu")
    try:
        losses = [trainer.run_step(step, next(batches))[0] for step in steps]
    finally:
        batches.close()
    return trainer, losses


def test_off_records_nothing_and_on_changes_no_bit():
    assert spans.span("train:adam") is spans._NULL
    off_trainer, off_losses = _train()
    off = spans.export()
    assert off["spans"] == []
    assert not any(k.startswith("host_syncs") for k in off["counters"])
    off_params = dict(off_trainer.params.named_parameters())

    spans.enable("cpu")
    trainer, on_losses = _train()
    spans.disable()
    assert spans.export()["spans"]
    for a, b in zip(off_losses, on_losses):
        assert torch.equal(a, b)
    for k, v in trainer.params.named_parameters():
        assert torch.equal(v.detach(), off_params[k]), k


def test_on_records_every_span_with_its_step_nested_on_the_host_clock():
    spans.enable("cpu")
    _train(steps=(0, 1))
    spans.disable()
    exported = spans.export()["spans"]
    assert {s["name"] for s in exported} >= STEP_SPANS
    by_id = {s["id"]: s for s in exported}
    for s in exported:
        assert s["step"] in (0, 1) or s["name"] == "data:build", s  # built ahead
        assert s["host_start_ns"] <= s["host_end_ns"]
        parent = by_id.get(s["parent"])
        if parent is not None:
            assert parent["step"] == s["step"]
            assert parent["host_start_ns"] <= s["host_start_ns"]
            assert s["host_end_ns"] <= parent["host_end_ns"]
    steps = {s["step"]: s for s in exported if s["name"] == "loop:step"}
    assert set(steps) == {0, 1}
    # every 16 steps; the budget's reads every 25 here
    for name in ("loop:occupancy", "loop:budget"):
        assert [s["step"] for s in exported if s["name"] == name] == [0]
    for s in exported:
        if s["name"].startswith("bwd:"):
            assert by_id[s["parent"]]["name"] == "train:backward"
        if s["name"] in ("train:forward", "train:backward", "train:adam", "loop:occupancy"):
            assert s["parent"] == steps[s["step"]]["id"]


def test_train_reduce_span_under_a_mesh(tmp_path):
    import torch.distributed as dist

    from nersemble_tpu_torch.parallel.mesh import DataMesh

    cfg, _ = tiny_config(None)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        trainer = NeRSembleTrainer(cfg, n_rays=64, device="cpu",
                                   mesh=DataMesh(dist.group.WORLD, "gloo"))
        calls = spans.counter("comm_calls")
        spans.enable("cpu")
        trainer.run_step(1, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})
        spans.disable()
    finally:
        dist.destroy_process_group()
    exported = spans.export()["spans"]
    reduce = [s for s in exported if s["name"] == "train:reduce"]
    assert len(reduce) == 1 and reduce[0]["step"] == 1
    assert spans.counter("comm_calls") > calls and spans.counter("comm_s") > 0


def test_a_span_on_another_thread_takes_the_steps_backward_as_parent():
    spans.enable("cpu")
    seen = []

    def autograd_thread():
        with spans.span("bwd:fused_mlp"):
            seen.append(spans.TRACER.site())

    with spans.span("loop:step", step=7):
        with spans.span("train:backward") as backward:
            worker = threading.Thread(target=autograd_thread)
            worker.start()
            worker.join(timeout=10)
            assert not worker.is_alive()
    with spans.span("data:build", step=9):  # explicit step: no link
        pass
    exported = {s["name"]: s for s in spans.export()["spans"]}
    assert exported["bwd:fused_mlp"]["parent"] == backward.id
    assert exported["bwd:fused_mlp"]["step"] == 7
    assert exported["bwd:fused_mlp"]["thread"] != exported["train:backward"]["thread"]
    assert seen == ["bwd:fused_mlp"]
    assert exported["data:build"]["parent"] is None and exported["data:build"]["step"] == 9


def test_host_syncs_count_the_log_and_budget_reads_at_their_sites(tmp_path):
    cfg, params = tiny_config(None)
    trainer = NeRSembleTrainer(cfg, n_rays=64, device="cpu", params=params)
    trainer.writer = MetricsWriter(tmp_path, enabled=False)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    spans.enable("cpu")
    total, aux = trainer.run_step(1, batch)  # no budget read at step 1
    assert not any(k.startswith("host_syncs") for k in spans.counters())
    total, aux = trainer.run_step(25, batch)  # the budget's cadence
    with spans.span("loop:log", step=25):
        logged = trainer._log(25, total, aux, 64, 1.0)
    spans.host_value(total)  # a read outside every span
    counts = spans.counters()
    assert counts["host_syncs.loop:budget"] == 2
    # loss, psnr, two sample counts, the budget's drops and every loss term
    assert counts["host_syncs.loop:log"] == 5 + len(aux["losses"])
    assert counts["host_syncs.outside"] == 1
    assert logged["train_loss"] == float(total)


def test_span_launches_match_the_launch_counters(monkeypatch):
    for module, counter in launch_counts.COUNTERS.values():
        monkeypatch.setattr(module, counter, 0)
    spans.enable("cpu")
    # a host-only span open meanwhile (the prefetch thread's): no launches
    build = spans.span("data:build", step=4, device=False).open(stacked=False)
    with spans.span("train:backward", step=3):
        with spans.span("bwd:quad_fold"):
            quad_kernel.FOLD_LAUNCHES += 2
        quad_kernel.LAUNCHES += 1
    build.close()
    spans.disable()
    exported = {s["name"]: s for s in spans.export()["spans"]}
    assert exported["bwd:quad_fold"]["launches"] == {"quad_fold": 2}
    assert exported["train:backward"]["launches"] == {"quad_fold": 2, "quad_build": 1}
    assert exported["data:build"]["launches"] == {}
    counts = spans.counters()
    assert {k: counts[f"launches.{k}"] for k in launch_counts.KERNELS} == launch_counts.read()


class _Event:
    """A CUDA event's stand-in: its time in ms, taken from ``times`` when
    recorded."""

    times = []

    def __init__(self, enable_timing=False):
        self.ms = None

    def record(self):
        self.ms = self.times.pop(0)

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_export_places_device_times_on_the_host_clock(monkeypatch):
    spans.enable("cpu")
    with spans.span("train:adam", step=0):
        pass
    on_cpu = spans.export()["spans"][0]  # on the CPU the device is the host
    assert on_cpu["device_start_ns"] == on_cpu["host_start_ns"]
    assert on_cpu["device_end_ns"] == on_cpu["host_end_ns"]
    # on a card: the anchor event's host time plus each event's time after it
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(_Event, "times", [10.0, 11.5, 12.25])
    tracer = spans.Tracer()
    tracer.cuda = True
    anchor = _Event()
    anchor.record()
    tracer._anchor = (anchor, 5_000_000)
    with spans.Span(tracer, "train:adam", 0):
        pass
    with spans.Span(tracer, "data:build", 1, device=False):
        pass
    placed, unplaced = tracer.export()["spans"]
    assert (placed["device_start_ns"], placed["device_end_ns"]) == (6_500_000, 7_250_000)
    assert unplaced["device_start_ns"] is None and unplaced["name"] == "data:build"


def _x(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def _span(name, id_, parent, t0_us, t1_us, thread, profiled=True):
    return {"name": name, "id": id_, "parent": parent, "step": 0, "thread": thread,
            "host_start_ns": int(t0_us * 1e3), "host_end_ns": int(t1_us * 1e3),
            "profiled": profiled}


def test_idle_by_span_names_a_gap_after_the_innermost_span_on_another_thread():
    """A profiler trace whose clock runs 1000 us ahead of the spans': one
    step, 0-100 us, with kernels at 0-10, 30-60 and 80-100. The gap at
    10-30 begins inside the autograd thread's ``bwd:time_code`` (deeper
    than the loop thread's ``train:backward``), the gap at 60-80 inside
    ``train:backward`` alone, while the prefetch thread's ``data:build``
    is open throughout."""
    events = [_x("loop:step", 1000, 100),
              _x("k1", 1000, 10, "kernel"), _x("k2", 1030, 30, "kernel"),
              _x("k3", 1080, 20, "kernel")]
    traced = [_span("loop:step", 1, None, 0, 100, 1),
              _span("train:backward", 2, 1, 5, 95, 1),
              _span("bwd:time_code", 3, 2, 8, 20, 2),
              _span("data:build", 4, None, 0, 100, 3),
              _span("loop:step", 5, None, -500, -400, 1, profiled=False)]
    assert spans.clock_offset(events, traced) == 1000
    idle = spans.idle_by_span(events, traced)
    assert idle["window_s"] == pytest.approx(100e-6)
    assert idle["busy_s"] == pytest.approx(60e-6)
    assert idle["by_span"] == pytest.approx({"bwd:time_code": 20e-6,
                                             "train:backward": 20e-6})
    # only the background span open: named after it; none open: outside
    assert spans.idle_by_span(events, traced[:1] + traced[3:])["by_span"] == \
        pytest.approx({"loop:step": 40e-6})
    lone = [_span("loop:step", 1, None, 0, 20, 1), _span("data:build", 4, None, 50, 70, 3)]
    assert spans.idle_by_span(events, lone)["by_span"] == \
        pytest.approx({"loop:step": 20e-6, "data:build": 20e-6})
    assert spans.idle_by_span(events, lone[:1] + [_span("x", 6, None, 40, 50, 1)]) \
        ["by_span"] == pytest.approx({"loop:step": 20e-6, "outside": 20e-6})
    events_after = events + [_x("loop:step", 2000, 10)]  # more steps than spans
    assert spans.idle_by_span(events_after, traced) == {}


def test_counters_lose_no_update_across_threads():
    calls = spans.counter("comm_calls")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [spans.count("comm_calls")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert spans.counter("comm_calls") - calls == 16 * 2000


def test_profile_dir_writes_the_segments_spans(tmp_path, monkeypatch):
    """The train CLI with ``NERSEMBLE_PROFILE_DIR``: steps 10-14 traced,
    ``spans.json`` beside ``trace.json`` with the segment's spans on the
    profiler's clock (the log at step 10 among them), its idle time by span
    and the counters; the tracer off again after."""
    from nersemble_tpu_torch import env
    from nersemble_tpu_torch.scripts import train_nersemble
    from nersemble_tpu_torch.utils.synthetic_capture import write_capture

    write_capture(tmp_path / "data", 30, "SYN-1", n_timesteps=2, original_size=(64, 48))
    monkeypatch.setattr(env, "NERSEMBLE_DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setattr(env, "NERSEMBLE_MODELS_PATH", str(tmp_path / "models"))
    monkeypatch.setenv("NERSEMBLE_PROFILE_DIR", str(tmp_path / "profile"))
    train_nersemble.main([
        "30", "SYN-1", "--device", "cpu", "--name", "spans", "--max-num-iterations", "16",
        "--steps-per-save", "0", "--steps-per-eval-image", "0",
        "--n-train-rays", "64", "--num-levels", "4", "--log2-hashmap-size", "9",
        "--max-res", "32", "--grid-resolution", "16", "--n-hash-encodings", "4",
        "--latent-dim-time", "4", "--latent-dim-time-deform", "8",
        "--mlp-num-layers", "2", "--mlp-layer-width", "16",
        "--max-samples-per-ray", "24", "--max-candidates-per-ray", "64"])
    assert not spans.is_on()
    out = tmp_path / "profile"
    assert (out / "trace.json").exists() and (out / "kernels.txt").exists()
    written = json.loads((out / "spans.json").read_text())
    steps = sorted(e["args"]["step"] for e in written["traceEvents"]
                   if e["name"] == "loop:step" and e["pid"] == "host")
    assert steps == [10, 11, 12, 13, 14]
    assert any(e["name"] == "loop:log" and e["args"]["step"] == 10
               for e in written["traceEvents"])
    # the segment's counts: one log (step 10) of 5 + 6 loss terms reads
    assert written["counters"]["host_syncs.loop:log"] == 11
    assert written["counters"]["batch_wait_s"] > 0
    # no device on the CPU: the whole segment is one gap, named after a span
    # open at its start or, by a few us of the two clocks' pairing, outside
    idle = written["idle_by_span"]
    assert idle["idle_s"] == pytest.approx(idle["window_s"])
    assert len(idle["by_span"]) == 1
    assert set(idle["by_span"]) <= {e["name"] for e in written["traceEvents"]} | {"outside"}
    # the profiler's loop:step ranges and the spans' line up
    ranges = sorted(e["ts"] for e in json.loads((out / "trace.json").read_text())["traceEvents"]
                    if e.get("name") == "loop:step" and e.get("cat") == "user_annotation")
    placed = sorted(e["ts"] for e in written["traceEvents"]
                    if e["name"] == "loop:step" and e["pid"] == "host")
    assert np.allclose(ranges, placed, atol=1e3)
