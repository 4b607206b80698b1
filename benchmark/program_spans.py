"""The port's own spans and counters (``nersemble_tpu_torch/utils/spans.py``)
in a training cell: what tracing costs, three per-layer readings that the
layer timers cannot give, the spans' device time beside the timers', and a
profiled segment's idle time by span.

    python -m benchmark.program_spans --workload nersemble.train --seed <n> --seconds <s> [--out FILE]

Set-up as ``loops/train.py`` builds the cell; then eight windows of
``--seconds``, untraced, traced (the port's tracer on), traced, untraced,
twice (the tracer's cost: the traced windows' rate against the untraced
ones'; the readers read the last traced window), a ninth with the
tracer and the layer timers (``trace.py``) both on, and a torch.profiler
segment of the traffic's ``profile_steps`` steps, each in ``bench:step`` as
the traced run has it, with the tracer on. No check runs. Prints one JSON
line (and writes it to ``--out``).

The readers take a traced window's dict, ``{"steps": n, "spans":
spans.export()}``, and return None when it holds no spans (a program
without the tracer):

- ``occupancy_update_ms``: device ms of every ``loop:occupancy`` span over
  the window's steps (an update every 16);
- ``host_syncs_per_step``: the reads of a device value on the host
  (``host_syncs.<site>``, every site, the benchmark's own log reads under
  ``outside``) over the steps;
- ``backward_issue_ms``: host ms of ``train:backward`` a step, the time
  autograd takes to issue the backward.
"""

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

from benchmark import run as bench_run  # first: it puts the kernel caches in the checkout

import torch  # noqa: E402

# program spans beside the layer timers' brackets (trace.py), per layer
PAIRS = {"adam": ("train:adam",), "encode_fwd": ("encode:quad_build", "encode:fwd"),
         "encode_bwd": ("bwd:hash_encode", "bwd:quad_fold"),
         "mlp_bwd": ("bwd:fused_mlp",), "time_code_bwd": ("bwd:time_code",)}


def _spans(trace: Dict) -> Optional[List[Dict]]:
    exported = trace.get("spans")
    if not exported or not trace.get("steps"):
        return None
    return exported["spans"]


def _ms(s: Dict, clock: str) -> float:
    a, b = s[f"{clock}_start_ns"], s[f"{clock}_end_ns"]
    return 0.0 if a is None else (b - a) * 1e-6


def occupancy_update_ms(trace: Dict) -> Optional[float]:
    spans = _spans(trace)
    if spans is None:
        return None
    updates = [s for s in spans if s["name"] == "loop:occupancy"]
    return sum(_ms(s, "device") for s in updates) / trace["steps"] if updates else None


def host_syncs_per_step(trace: Dict) -> Optional[float]:
    if _spans(trace) is None:
        return None
    counters = trace["spans"]["counters"]
    return sum(v for k, v in counters.items() if k.startswith("host_syncs.")) / trace["steps"]


def backward_issue_ms(trace: Dict) -> Optional[float]:
    spans = _spans(trace)
    if spans is None:
        return None
    backward = [s for s in spans if s["name"] == "train:backward"]
    return sum(_ms(s, "host") for s in backward) / trace["steps"] if backward else None


READERS = {"occupancy_update_ms.train": occupancy_update_ms,
           "host_syncs_per_step.train": host_syncs_per_step,
           "backward_issue_ms.train": backward_issue_ms}


def by_span(spans: List[Dict], steps: int) -> Dict[str, Dict[str, float]]:
    """Per span name, a step's calls, host ms, device ms and launches."""
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for s in spans:
        row = out[s["name"]]
        row["calls"] += 1 / steps
        row["host_ms"] += _ms(s, "host") / steps
        row["device_ms"] += _ms(s, "device") / steps
        for kernel, n in s["launches"].items():
            row[f"launches.{kernel}"] += n / steps
    return {k: dict(v) for k, v in sorted(out.items())}


def beside_timers(spans: List[Dict], steps: int, layers: Dict) -> Dict:
    """Device ms a step of each layer by the layer timers and by the
    program's spans (the encode's spans under ``loop:occupancy`` left out:
    the timers do not time calls without gradients)."""
    by_id = {s["id"]: s for s in spans}

    def in_update(s) -> bool:
        while s is not None:
            if s["name"] == "loop:occupancy":
                return True
            s = by_id.get(s["parent"])
        return False
    out = {}
    for layer, names in PAIRS.items():
        ms = sum(_ms(s, "device") for s in spans if s["name"] in names and not in_update(s))
        timers = layers.get(layer, {}).get("ms")
        out[layer] = {"spans_ms": ms / steps,
                      "timers_ms": None if timers is None else timers / steps}
    return out


def harness_split(events: List[Dict], spans: List[Dict], bucket: str) -> Dict[str, float]:
    """The idle seconds that ``profile.py`` puts down to ``bucket`` (the
    innermost host range of the loop's thread when the gap began), by the
    program span each gap began in (``spans.idle_gaps``)."""
    from benchmark.profile import HOST_CATS, STEP_RANGE
    from nersemble_tpu_torch.utils import spans as port_spans

    found = port_spans.idle_gaps(events, spans, window_range=STEP_RANGE)
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    steps = [e for e in complete if e.get("name") == STEP_RANGE]
    if not found or not steps:
        return {}
    host = sorted((e for e in complete if e.get("cat") in HOST_CATS
                   and e.get("tid") == steps[0].get("tid")), key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    out: Dict[str, float] = defaultdict(float)
    for a, b, name in found["gaps"]:
        loop_name = "idle"
        for i in range(bisect.bisect_right(starts, a) - 1, -1, -1):
            if host[i]["ts"] + host[i]["dur"] > a:
                loop_name = host[i]["name"]
                break
        if loop_name == bucket:
            out[name] += (b - a) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def measure(cell, ctx, seconds: float) -> Dict:
    """The windows and the profiled segment on a set-up cell."""
    from benchmark import profile, trace
    from benchmark.reference.nersemble_ref import grid_layout
    from nersemble_tpu_torch.utils import spans

    out: Dict = {"windows": []}
    traced = None
    for on in (False, True, True, False) * 2:  # in turns, so that a drift cancels
        spans.reset()
        if on:
            spans.enable(ctx.device)
        win = cell.window(seconds)
        rate = win["rays"] / win["seconds"]
        out["windows"].append({"tracer": on, "steps": win["steps"], "rays_per_s": rate})
        if on:
            traced = {"steps": win["steps"], "spans": spans.export()}
            spans.disable()
    untraced = [w["rays_per_s"] for w in out["windows"] if not w["tracer"]]
    on_rates = [w["rays_per_s"] for w in out["windows"] if w["tracer"]]
    out["tracing_cost"] = 1.0 - sum(on_rates) / sum(untraced)
    out["metrics"] = {name: read(traced) for name, read in READERS.items()}
    out["by_span"] = by_span(traced["spans"]["spans"], traced["steps"])
    out["counters"] = traced["spans"]["counters"]

    spans.reset()
    spans.enable(ctx.device)
    timers = trace.LayerTimers(ctx.device, grid_layout(cell.model_dict))
    timers.install()
    try:
        win = cell.window(seconds)
    finally:
        timers.uninstall()
    both = spans.export()
    spans.disable()
    out["with_timers"] = {"steps": win["steps"], "rays_per_s": win["rays"] / win["seconds"],
                          "layers": beside_timers(both["spans"], win["steps"],
                                                  timers.totals())}

    spans.reset()
    spans.enable(ctx.device)
    events = _profiled(cell, ctx.traffic["profile_steps"], ctx.device)
    segment = spans.export()
    spans.disable()
    out["profile"] = profile.parse(events)
    out["idle_by_span"] = spans.idle_by_span(events, segment["spans"],
                                             window_range=profile.STEP_RANGE)
    out["train_backward_split"] = harness_split(events, segment["spans"], "train:backward")
    out["segment_by_span"] = by_span(segment["spans"], ctx.traffic["profile_steps"])
    return out


def _profiled(cell, n_steps: int, device) -> List[Dict]:
    """The Chrome trace's events of ``n_steps`` steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.profile import STEP_RANGE

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(n_steps):
            with torch.profiler.record_function(STEP_RANGE):
                cell.one_step()
        cell.sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def run(workload: str, seed: int, seconds: float, device, capture_root=None,
        cell_files=None) -> Dict:
    from benchmark.loops.train import TrainCell

    wl, config, traffic, limits, bench = cell_files or bench_run.load_cell(workload)
    ctx = bench_run.RunContext(config, traffic, seed, seconds, True, device, capture_root)
    cell = TrainCell(config, traffic, seed, device, capture_root=capture_root)
    cell.setup()
    try:
        out = measure(cell, ctx, seconds)
    finally:
        cell.close()
    out["setup_s"] = time.perf_counter() - ctx.t_start
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("program_spans: a CUDA device is needed", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": bench_run.power_limit(), "workload": args.workload, "seed": args.seed,
           **run(args.workload, args.seed, args.seconds, "cuda:0")}
    out["forbidden_loaded"] = bench_run.loaded_forbidden()
    line = json.dumps(bench_run.finite(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 3 if out["forbidden_loaded"] else 0


if __name__ == "__main__":
    sys.exit(main())
