"""A short torch.profiler segment of the loop: the device's busy and idle
time, the operations that took most of it, and the idle gaps named by what
the host was doing.

The segment's Chrome trace is written to a temporary file (under TMPDIR)
and read back: device activity is every event of the categories
``kernel``, ``gpu_memcpy`` and ``gpu_memset``; the window runs from the
first ``bench:step`` range on the host to the end of the last step's
device work. An idle gap (no device activity) is named after the
innermost host range (``user_annotation``, ``cpu_op`` or
``python_function``) of the loop's thread that was open when the gap
began.
"""

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "python_function")
STEP_RANGE = "bench:step"


def record(run_steps, device) -> Dict:
    """Profile ``run_steps()`` (which wraps each step in ``STEP_RANGE``);
    returns the parsed trace (``parse``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        run_steps()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return parse(events)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def parse(events: List[Dict]) -> Dict:
    """busy_s, window_s, the top device operations and idle gaps (seconds,
    at most 10 each) of a Chrome trace's events."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    steps = [e for e in complete if e.get("name") == STEP_RANGE]
    device = [e for e in complete if e.get("cat") in DEVICE_CATS]
    if not steps:
        return {}
    t0 = min(e["ts"] for e in steps)
    host_end = max(e["ts"] + e["dur"] for e in steps)
    dev = [(max(e["ts"], t0), e["ts"] + e["dur"]) for e in device
           if e["ts"] + e["dur"] > t0]
    t1 = max([host_end] + [b for _, b in dev])
    busy = _merge([(a, b) for a, b in dev if b > a])
    busy_us = sum(b - a for a, b in busy)

    by_name: Dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e["name"]] += e["dur"]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    loop_tid = steps[0].get("tid")
    host = sorted((e for e in complete if e.get("cat") in HOST_CATS
                   and e.get("tid") == loop_tid), key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        name = "idle"
        # the innermost open range: the latest start that still covers a
        for i in range(bisect.bisect_right(starts, a) - 1, -1, -1):
            if host[i]["ts"] + host[i]["dur"] > a:
                name = host[i]["name"]
                break
        gaps[name] += b - a
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": (t1 - t0) * 1e-6,
            "steps": len(steps),
            "device_ops": [[k, v * 1e-6] for k, v in ops],
            "idle_gaps": [[k, v * 1e-6] for k, v in idle]}
