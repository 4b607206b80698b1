"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` (at the root of
the checkout). Its configuration file and its traffic file
(``benchmark/traffic/<traffic>.json``) are found by name; the traffic's
``loop`` names the driver (``benchmark/loops/<loop>.py``), whose ``run``
does set-up, the measured window and the check; the configuration's
limits are ``benchmark/limits/<config>.json``. With ``--trace 1`` each
per-layer metric of the cell is read by its own reader,
``benchmark/metrics/<metric>.py`` (``read(trace) -> float or None``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
when traced), then ``checks``: each compared number beside its limit,
which also end standard error. Without a CUDA device, or with fewer
devices than the cell asks for, it prints no result and exits with 2; if
JAX or the JAX package was loaded, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / "cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "nersemble_tpu")


def _cache_env() -> None:
    """Kernel caches at fixed folders inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


_cache_env()

import torch  # noqa: E402


class RunContext:
    """What a loop's ``run`` gets."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, seconds: float,
                 trace: bool, device, capture_root=None):
        self.config, self.traffic = config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.capture_root = capture_root
        self.t_start = T_START


def load_cell(name: str, root: Path = ROOT):
    """(workload, configuration file, traffic file, limits, BENCHMARK.json)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{workload['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload['config']}.json").read_text())
    return workload, config, traffic, limits, bench


def read_metric(name: str, trace: Dict):
    """``benchmark/metrics/<name>.py``'s reading of the trace (None when it
    finds nothing to read)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(trace)


def cell_metrics(bench: Dict, workload: Dict, kind: str):
    """The cell's end-to-end (``kind`` "end_to_end") or per-layer metrics."""
    name = workload["name"]
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def loaded_forbidden():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def execute(workload, config, traffic, limits, bench, seed, seconds, trace,
            device, capture_root=None) -> Dict:
    """One run of the cell on ``device``; returns the result line's dict."""
    from benchmark import check
    ctx = RunContext(config, traffic, seed, seconds, trace, device, capture_root)
    loop = importlib.import_module(f"benchmark.loops.{traffic['loop']}")
    raw = loop.run(ctx)
    metrics = {}
    for m in cell_metrics(bench, workload, "end_to_end" if not trace else "per_layer"):
        value = raw["metrics"].get(m["name"]) if not trace \
            else read_metric(m["name"], raw["trace"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = ctx.device
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": raw["peak_bytes"]}
    verdict = check.judge(raw["numbers"], limits)
    out = {"correct": verdict["correct"], "attempted": raw["attempted"],
           "failed": raw["failed"], "metrics": metrics, "device": device_info}
    if trace:
        prof = raw["trace"]["profile"]
        device_info["busy_s"] = prof.get("busy_s", 0.0)
        device_info["window_s"] = prof.get("window_s", 0.0)
        out["breakdown"] = {"device_ops": prof.get("device_ops", []),
                            "idle_gaps": prof.get("idle_gaps", [])}
    out["checks"] = verdict["checks"]
    return out


def finite(x):
    """``x`` with every non-finite float replaced by None (JSON has no NaN)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not (x == x and abs(x) != float("inf")):
        return None
    return x


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    workload, config, traffic, limits, bench = load_cell(args.workload)
    need = workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: {need} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"# {power_limit()}", file=sys.stderr)
    out = execute(workload, config, traffic, limits, bench, args.seed, args.seconds,
                  bool(args.trace), "cuda:0")
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
