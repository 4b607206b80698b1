"""The readers of the port's spans (``program_spans.py``): nothing read from
a trace without spans, the values of a synthetic one; and the tool's run of
a tiny cell on the CPU. CPU only.

    python -m pytest benchmark/test_bench_spans.py -q
"""

import pytest

from benchmark import program_spans
from benchmark.test_bench_cell import SEED, tiny


def _span(name, id_, parent, step, host_ms, device_ms, launches=None):
    return {"name": name, "id": id_, "parent": parent, "step": step, "thread": 1,
            "host_start_ns": 0, "host_end_ns": int(host_ms * 1e6),
            "device_start_ns": 10, "device_end_ns": 10 + int(device_ms * 1e6),
            "launches": launches or {}, "profiled": False}


def _trace():
    """Two steps; one occupancy update (8 ms on the device); 30 and 40 ms
    of the backward's issue; three host reads."""
    spans = [_span("loop:step", 1, None, 16, 90, 80),
             _span("loop:occupancy", 2, 1, 16, 9, 8, {"quad_build": 1}),
             _span("encode:fwd", 3, 2, 16, 1, 2, {"blended_encode_fwd": 1}),
             _span("train:backward", 4, 1, 16, 30, 25),
             _span("bwd:time_code", 5, 4, 16, 5, 20),
             _span("loop:step", 6, None, 17, 70, 60),
             _span("train:backward", 7, 6, 17, 40, 25),
             _span("encode:fwd", 8, 6, 17, 1, 3, {"blended_encode_fwd": 1})]
    counters = {"host_syncs.outside": 2.0, "host_syncs.loop:budget": 1.0,
                "batch_wait_s": 0.5, "launches.quad_build": 1}
    return {"steps": 2, "spans": {"spans": spans, "counters": counters}}


@pytest.mark.parametrize("name", sorted(program_spans.READERS))
def test_a_trace_without_spans_reads_nothing(name):
    read = program_spans.READERS[name]
    assert read({"steps": 10}) is None
    assert read({"steps": 0, "spans": {"spans": [], "counters": {}}}) is None


def test_readers_of_a_synthetic_trace():
    trace = _trace()
    assert program_spans.occupancy_update_ms(trace) == pytest.approx(4.0)
    assert program_spans.host_syncs_per_step(trace) == pytest.approx(1.5)
    assert program_spans.backward_issue_ms(trace) == pytest.approx(35.0)
    rows = program_spans.by_span(trace["spans"]["spans"], 2)
    assert rows["encode:fwd"] == pytest.approx({"calls": 1.0, "host_ms": 1.0, "device_ms": 2.5,
                                                "launches.blended_encode_fwd": 1.0})
    layers = program_spans.beside_timers(trace["spans"]["spans"], 2,
                                         {"time_code_bwd": {"ms": 50.0}})
    # the update's encode is left out, as the timers leave it out
    assert layers["encode_fwd"] == {"spans_ms": pytest.approx(1.5), "timers_ms": None}
    assert layers["time_code_bwd"] == {"spans_ms": pytest.approx(10.0), "timers_ms": 25.0}


def test_harness_split_of_a_synthetic_segment():
    """One step, 0-100 us, kernels at 0-10, 30-60, 80-100; the loop thread
    in ``train:backward`` from 5 us, the autograd thread's
    ``bwd:time_code`` open at 8-20 us: of the 40 us that profile.py puts
    down to ``train:backward``, the gap at 10 us began in ``bwd:time_code``."""
    events = [{"ph": "X", "name": name, "cat": "user_annotation", "ts": ts, "dur": dur,
               "tid": 1} for name, ts, dur in (("bench:step", 1000, 100),
                                               ("loop:step", 1000, 100),
                                               ("train:backward", 1005, 90))]
    events += [{"ph": "X", "name": "k", "cat": "kernel", "ts": ts, "dur": dur, "tid": 9}
               for ts, dur in ((1000, 10), (1030, 30), (1080, 20))]
    spans = [_span("loop:step", 1, None, 0, 0.1, 0), _span("train:backward", 2, 1, 0, 0.09, 0),
             _span("bwd:time_code", 3, 2, 0, 0.012, 0)]
    for s, start_us in zip(spans, (0, 5, 8)):
        s["host_start_ns"] += start_us * 1000
        s["host_end_ns"] += start_us * 1000
        s["profiled"] = True
    assert program_spans.harness_split(events, spans, "train:backward") == \
        pytest.approx({"bwd:time_code": 20e-6, "train:backward": 20e-6})


def test_the_tool_runs_a_tiny_cell(tmp_path):
    out = program_spans.run("nersemble.train", SEED, 1.0, "cpu", capture_root=tmp_path,
                            cell_files=tiny("nersemble"))
    assert [w["tracer"] for w in out["windows"]] == [False, True, True, False] * 2
    assert all(w["steps"] > 0 for w in out["windows"])
    assert out["metrics"]["backward_issue_ms.train"] > 0
    # the benchmark's log reads count only on a card (sync warnings)
    assert out["metrics"]["host_syncs_per_step.train"] is not None
    assert {"loop:step", "train:backward", "bwd:time_code", "loop:batch_wait"} <= \
        set(out["by_span"])
    assert set(out["with_timers"]["layers"]) == set(program_spans.PAIRS)
    assert out["with_timers"]["layers"]["adam"]["timers_ms"] > 0
    assert set(out["train_backward_split"]) <= set(out["by_span"]) | {"outside"}
    idle = out["idle_by_span"]
    # no device on the CPU: one gap, the whole segment
    assert idle["idle_s"] == pytest.approx(idle["window_s"])
    assert sum(idle["by_span"].values()) == pytest.approx(idle["idle_s"])
