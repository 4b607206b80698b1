"""The port's tracer: spans at the layer boundaries of the training loop and
the renderer, and counters at the same boundaries, on one clock with the
device.

``span(name)`` marks a layer's work where it happens::

    with spans.span("train:adam"):
        ...

- Tracer off, no torch profiler running: ``span`` returns a shared no-op
  context at once (no profiler range, no CUDA event, no device memory, no
  sync).
- A torch profiler running: the span is a ``record_function`` range of
  the same name.
- Tracer on (``enable``): the span also records its name, id, parent id,
  step (the identifier that all of one step's spans share), thread, host
  start and end (``time.perf_counter_ns``) and, unless ``device=False``
  (host-only work), a CUDA event pair on the current stream (on a CUDA
  device) and the hand kernels' launches issued inside it
  (``ops/launch_counts.py``).
  ``export()`` hands the spans out with their device times placed on the
  host clock by an anchor event taken at ``enable``.

A span opened on a thread that has no open span (on the card the autograd
engine runs the backward on a thread of its own) takes the open
``train:backward`` of the current step as its parent: a context variable
does not cross to that thread, so spans are linked by step.
``backward_span`` brackets the backward of a function that launches no
hand kernel of its own (the time codes' gather) by identity autograd nodes,
inserted only while the tracer is on.

Counters: ``batch_wait_s`` and ``batch_copy_s`` (``DeviceBatches``),
``comm_calls`` and ``comm_s`` (``DataMesh``) count whether the tracer is on
or not, each a host add, as the attributes they replace did. ``tally``
counts only while the tracer is on, and takes device values without
reading them (summed on their device, read by ``counters()``): the
renderer's ``samples_valid``, ``samples_evaluated`` (rows the field
evaluated, padding included), ``samples_budget_dropped`` and
``field_chunks``. While the
tracer is on, ``host_syncs.<site>`` counts each read of a device value on
the host: the loop's own through ``host_value`` and, on a CUDA device, any
other, which ``torch.cuda.set_sync_debug_mode("warn")`` turns into a warning
that is counted and not printed. The site is the innermost open span, or
``outside``. ``counters()`` adds ``launches.<kernel>``, the launch counters'
totals.

``idle_by_span`` names each idle gap of a torch.profiler segment after the
innermost span open when the gap began, on any thread.
"""

import itertools
import statistics
import threading
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

from nersemble_tpu_torch.ops import launch_counts

STEP = "loop:step"
BACKWARD = "train:backward"
OUTSIDE = "outside"
# spans of threads that issue no device work: an idle gap is named after
# one only when no other span is open
BACKGROUND = ("data:build",)
SYNC_WARNING = "called a synchronizing CUDA operation"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _profiling() -> bool:
    return getattr(_profiler, "_is_profiler_enabled", True)


class Span:
    """One recorded span; a context manager, or opened and closed by hand
    (``open``, ``close``) where its ends lie in two calls."""

    __slots__ = ("tracer", "name", "id", "parent", "step", "thread", "t0", "t1",
                 "events", "launches", "profiled", "_launches0", "_range",
                 "_stacked", "_issues")

    def __init__(self, tracer: "Tracer", name: str, step: Optional[int],
                 device: bool = True):
        self.tracer, self.name, self.step = tracer, name, step
        self._issues = device  # issues device work: events and launches
        self.events = self._range = None
        self.launches: Dict[str, int] = {}

    def open(self, stacked: bool = True) -> "Span":
        tr = self.tracer
        stack = tr._stack()
        parent = stack[-1] if stack else None
        if parent is None and self.step is None:
            parent = tr._backward.get(tr.step)
        if self.step is None:
            self.step = parent.step if parent is not None else tr.step
        self.parent = parent.id if parent is not None else None
        self.id = next(tr._ids)
        self.thread = threading.get_ident()
        if self.name == STEP:
            tr.step = self.step
        elif self.name == BACKWARD:
            tr._backward[self.step] = self
        self._stacked = stacked
        if stacked:
            stack.append(self)
        self.profiled = _profiling()
        if self.profiled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._launches0 = launch_counts.read() if self._issues else {}
        self.t0 = time.perf_counter_ns()
        if self._issues and tr.cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.events = (start, None)
        return self

    def close(self) -> None:
        tr = self.tracer
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events = (self.events[0], end)
        self.t1 = time.perf_counter_ns()
        # the launch counters are the process's: a host-only span would
        # count other threads' launches
        if self._issues:
            launches = launch_counts.read()
            self.launches = {k: n - self._launches0[k] for k, n in launches.items()
                             if n != self._launches0[k]}
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._stacked:
            stack = tr._stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:
                stack.remove(self)
        if self.name == BACKWARD and tr._backward.get(self.step) is self:
            del tr._backward[self.step]
        tr.spans.append(self)

    def __enter__(self) -> "Span":
        return self.open()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class Tracer:
    """The process's spans and counters (one instance, ``TRACER``: the
    layers that open spans are reached through calls that do not carry
    it)."""

    def __init__(self):
        self.on = False
        self.cuda = False
        self.spans: List[Span] = []
        self.step: Optional[int] = None  # the step of the last loop:step
        self._backward: Dict[int, Span] = {}  # step -> its open train:backward
        self._counts: Dict[str, float] = defaultdict(float)
        self._tallies: Dict[str, torch.Tensor] = {}  # device values, unread
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._anchor = None  # (event, host ns) of the device clock's anchor
        self._restore = None  # what enable() changed, for disable()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def site(self) -> str:
        """The innermost open span of this thread (or the open
        ``train:backward`` of the current step), else ``outside``."""
        stack = self._stack()
        if stack:
            return stack[-1].name
        return BACKWARD if self.step in self._backward else OUTSIDE

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counts[name] += value

    def tally(self, name: str, value) -> None:
        if not isinstance(value, torch.Tensor):
            return self.count(name, float(value))
        value = value.detach().to(torch.float64)
        with self._lock:
            held = self._tallies.get(name)
            self._tallies[name] = value if held is None else held + value

    # -- on and off ------------------------------------------------------------

    def enable(self, device=None) -> None:
        if self.on:
            return
        device = torch.device(device if device is not None else
                              ("cuda" if torch.cuda.is_available() else "cpu"))
        self.cuda = device.type == "cuda"
        if self.cuda:
            if self._anchor is None:
                torch.cuda.synchronize(device)
                anchor = torch.cuda.Event(enable_timing=True)
                before = time.perf_counter_ns()
                anchor.record()
                torch.cuda.synchronize(device)
                self._anchor = (anchor, (before + time.perf_counter_ns()) // 2)
            self._count_syncs()
        self.on = True

    def _count_syncs(self) -> None:
        """Every synchronizing CUDA call warns, each warning counted at its
        site and not shown (a read through ``host_value`` counts there)."""
        shown = warnings.showwarning
        tracer = self

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING not in str(message):
                return shown(message, category, filename, lineno, file, line)
            if not getattr(tracer._local, "explicit", False):
                tracer.count(f"host_syncs.{tracer.site()}")

        mode = torch.cuda.get_sync_debug_mode()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        self._restore = (mode, shown, show, warnings.filters[0])
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")

    def disable(self) -> None:
        if not self.on:
            return
        self.on = False
        if self._restore is not None:
            mode, shown, show, entry = self._restore
            torch.cuda.set_sync_debug_mode(mode)
            if warnings.showwarning is show:
                warnings.showwarning = shown
            if entry in warnings.filters:
                warnings.filters.remove(entry)
                warnings._filters_mutated()
            self._restore = None

    def reset(self) -> None:
        """Forget every span and counter (and the anchor)."""
        self.disable()
        self.spans = []
        self._backward.clear()
        self.step = None
        self._anchor = None
        with self._lock:
            self._counts.clear()
            self._tallies.clear()

    # -- out -------------------------------------------------------------------

    def counters(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counts)
            tallies = dict(self._tallies)
        self._local.explicit = True  # the read is the counters', no step's
        try:
            for name, value in tallies.items():
                out[name] = out.get(name, 0.0) + float(value)
        finally:
            self._local.explicit = False
        out.update({f"launches.{k}": n for k, n in launch_counts.read().items()})
        return out

    def export(self) -> Dict:
        """``{"spans": [...], "counters": {...}}``: each closed span as a dict
        (name, id, parent, step, thread, host_start_ns, host_end_ns,
        device_start_ns, device_end_ns, launches, profiled), its device times
        on the host's ``perf_counter_ns`` clock (on the CPU its host times;
        None for host-only spans)."""
        if self.cuda and self._anchor is not None:
            torch.cuda.synchronize()
        out = []
        for s in sorted(self.spans, key=lambda s: (s.t0, s.id)):
            if not s._issues:
                d0 = d1 = None
            elif s.events is not None:
                anchor, host = self._anchor
                d0, d1 = (host + round(anchor.elapsed_time(e) * 1e6) for e in s.events)
            else:
                d0, d1 = s.t0, s.t1
            out.append({"name": s.name, "id": s.id, "parent": s.parent,
                        "step": s.step, "thread": s.thread,
                        "host_start_ns": s.t0, "host_end_ns": s.t1,
                        "device_start_ns": d0, "device_end_ns": d1,
                        "launches": dict(s.launches), "profiled": s.profiled})
        return {"spans": out, "counters": self.counters()}


TRACER = Tracer()


def span(name: str, step: Optional[int] = None, device: bool = True):
    """A context for ``name``'s work: a no-op, a profiler range, or a
    recorded span (module docstring). ``step``: the step the work belongs
    to, where it is not the current one (a batch built or delivered ahead);
    ``device=False``: host-only work, no CUDA events and no launches."""
    if TRACER.on:
        return Span(TRACER, name, step, device)
    if _profiling():
        return torch.profiler.record_function(name)
    return _NULL


def enable(device=None) -> None:
    """Record spans (``device``: where their work runs; the card when there
    is one). Synchronizes once, the first time, to anchor the device clock."""
    TRACER.enable(device)


def disable() -> None:
    TRACER.disable()


def reset() -> None:
    TRACER.reset()


def is_on() -> bool:
    return TRACER.on


def export() -> Dict:
    return TRACER.export()


def count(name: str, value: float = 1.0) -> None:
    TRACER.count(name, value)


def tally(name: str, value=1.0) -> None:
    """Add ``value`` (a number, or a device tensor summed where it lies and
    read only by ``counters()``) to the counter ``name`` while the tracer
    is on; off, nothing."""
    if TRACER.on:
        TRACER.tally(name, value)


def counter(name: str) -> float:
    with TRACER._lock:
        return TRACER._counts.get(name, 0.0)


def counters() -> Dict[str, float]:
    return TRACER.counters()


def host_value(x) -> float:
    """``float(x)``: the loop's read of a device value on the host, counted
    at its site while the tracer is on."""
    tr = TRACER
    if not tr.on:
        return float(x)
    tr._local.explicit = True
    try:
        value = float(x)
    finally:
        tr._local.explicit = False
    tr.count(f"host_syncs.{tr.site()}")
    return value


class _Close(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, held):
        ctx.held = held
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.held:
            ctx.held.pop().close()
        return g, None


class _Open(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, held, name):
        ctx.held, ctx.name = held, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.held.append(Span(TRACER, ctx.name, None).open(stacked=False))
        return g, None, None


def backward_span(name: str, fn, x: torch.Tensor, *args):
    """``fn(x, *args)``; while the tracer is on and ``x`` takes a gradient,
    its backward, from the gradient's arrival at the output to its
    departure to ``x``, is the span ``name``. The span is no parent of the
    spans opened between its ends (the engine may run other nodes there)."""
    if not (TRACER.on and torch.is_grad_enabled() and x.requires_grad):
        return fn(x, *args)
    held: List[Span] = []
    return _Open.apply(fn(_Close.apply(x, held), *args), held, name)


# -- a torch.profiler segment ------------------------------------------------


def clock_offset(events: List[Dict], spans: List[Dict]) -> Optional[float]:
    """Microseconds to add to a span's host time (ns / 1e3) to place it on a
    torch.profiler Chrome trace's clock: the median over the ``loop:step``
    ranges the trace holds of their starts less those of the profiled
    ``loop:step`` spans, paired in order. None when either has none."""
    ranges = sorted(e["ts"] for e in events if e.get("name") == STEP
                    and e.get("cat") == "user_annotation" and e.get("ph") == "X")
    steps = sorted(s["host_start_ns"] for s in spans
                   if s["name"] == STEP and s["profiled"])
    if not ranges or len(ranges) != len(steps):
        return None
    return statistics.median(r - s / 1e3 for r, s in zip(ranges, steps))


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def idle_gaps(events: List[Dict], spans: List[Dict], window_range: str = STEP) -> Dict:
    """The idle gaps of a torch.profiler segment (its Chrome trace's
    ``events``; no kernel, copy or memset on the device), each named after
    the span open when it began: the deepest span open then on any thread
    (a ``bwd:*`` span of the autograd thread before the loop's
    ``train:backward``), a span of ``BACKGROUND`` only when no other is
    open, ``outside`` when none is. The segment runs from the first
    ``window_range`` range to the end of the last one or of the last device
    work, whichever is later. ``spans``: ``export()["spans"]``. Returns
    ``{"window_s", "busy_s", "gaps": [(start us, end us, name), ...]}`` on
    the trace's clock, or {} when the trace and the spans share no
    ``loop:step``."""
    offset = clock_offset(events, spans)
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = [e for e in complete if e.get("name") == window_range
              and e.get("cat") == "user_annotation"]
    if offset is None or not window:
        return {}
    t0 = min(e["ts"] for e in window)
    host_end = max(e["ts"] + e["dur"] for e in window)
    device = [(max(e["ts"], t0), e["ts"] + e["dur"]) for e in complete
              if e.get("cat") in DEVICE_CATS and e["ts"] + e["dur"] > t0]
    t1 = max([host_end] + [b for _, b in device])
    busy = _merge([(a, b) for a, b in device if b > a])

    depth: Dict[int, int] = {}
    by_id = {s["id"]: s for s in spans}

    def depth_of(s) -> int:
        if s["id"] not in depth:
            parent = by_id.get(s["parent"])
            depth[s["id"]] = 0 if parent is None else depth_of(parent) + 1
        return depth[s["id"]]

    placed = sorted((s["host_start_ns"] / 1e3 + offset, s["host_end_ns"] / 1e3 + offset,
                     s["name"] not in BACKGROUND, depth_of(s), s["name"])
                    for s in spans)
    gaps = []
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    active, i = [], 0  # the spans open at the gap's start (a sweep: gaps ascend)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        while i < len(placed) and placed[i][0] <= a:
            active.append(placed[i])
            i += 1
        active = [p for p in active if p[1] > a]
        gaps.append((a, b, max(active, key=lambda p: (p[2], p[3], p[0]))[4]
                     if active else OUTSIDE))
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "gaps": gaps}


def idle_by_span(events: List[Dict], spans: List[Dict],
                 window_range: str = STEP) -> Dict:
    """``idle_gaps`` summed by name: ``{"window_s", "busy_s", "idle_s",
    "by_span": {name: s}}`` (largest first), or {}."""
    found = idle_gaps(events, spans, window_range)
    if not found:
        return {}
    by_span: Dict[str, float] = defaultdict(float)
    for a, b, name in found["gaps"]:
        by_span[name] += (b - a) * 1e-6
    return {"window_s": found["window_s"], "busy_s": found["busy_s"],
            "idle_s": sum(by_span.values()),
            "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1]))}


def chrome_trace(spans: List[Dict], offset_us: float = 0.0) -> Dict:
    """The spans as a Chrome trace: host intervals under ``host``, device
    intervals under ``device``, one row per thread, shifted by ``offset_us``
    (``clock_offset``) onto a profiler trace's clock."""
    events = []
    for s in spans:
        args = {"id": s["id"], "parent": s["parent"], "step": s["step"],
                "launches": s["launches"]}
        for pid, a, b in (("host", s["host_start_ns"], s["host_end_ns"]),
                          ("device", s["device_start_ns"], s["device_end_ns"])):
            if a is not None:
                events.append({"name": s["name"], "ph": "X", "cat": "span",
                               "pid": pid, "tid": s["thread"],
                               "ts": a / 1e3 + offset_us, "dur": (b - a) / 1e3,
                               "args": args})
    return {"traceEvents": events}
