"""Device time of the program's layers in the traced run, from CUDA events
around the port's functions.

``LayerTimers.install`` wraps, for the traced run only, the functions the
layers' work goes through, found by module and name in the port:

- ``engine.trainer.fused_adam_update`` (Adam): events before and after;
- ``models.field.build_quad_table`` and ``models.field.hash_encode_blended``
  / ``hash_encode`` (the encode): events around each forward call, and
  identity autograd nodes on the call's output and on its table input
  whose backward records an event, so that each backward is bracketed by
  the gradient's arrival at the output and its departure from the input;
- ``ops.fused_mlp.fused_mlp_apply`` (the MLPs): such brackets on the
  backward;
- ``models.nersemble._gather_rows`` (the time codes): such brackets on the
  gather's backward.

A bracket holds every kernel its call launched, whatever the kernels are
named, so a kernel that replaces or fuses one still gets a reading.
Between two events the card may also idle while the host catches up, so a
share computed from a bracket's time is a lower bound. Calls with
gradients off (the occupancy update's field evaluations) are not timed.
Beside the times, the work of each call is counted (``roofline.py``):
from host shapes, and for the encode from the distinct table rows that the
step's positions touch.
"""

import time
from collections import defaultdict
from typing import Dict, List

import torch

from benchmark import roofline
from benchmark.reference.nersemble_ref import corner_rows


class _Mark(torch.autograd.Function):
    """Identity whose backward calls ``stamp``."""

    @staticmethod
    def forward(ctx, x, stamp):
        ctx.stamp = stamp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.stamp()
        return g, None


class LayerTimers:
    def __init__(self, device, lv: Dict):
        self.device = torch.device(device)
        self.lv = lv
        self.pairs: Dict[str, List[list]] = defaultdict(list)
        self.bound_ms: Dict[str, float] = defaultdict(float)
        self._patched = []
        self._touched = None       # [E] bool: rows the current step's encode reads
        self._rows = []            # device counts of distinct rows, one per step
        self._encode_samples = 0
        self._code_cols = 0

    # -- events --------------------------------------------------------------

    def _event(self):
        if self.device.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def _bracket(self, layer: str):
        """(open, close) stamps of a new bracket of ``layer``."""
        slot = [None, None]
        self.pairs[layer].append(slot)

        def open_():
            slot[0] = self._event()

        def close():
            slot[1] = self._event()
        return open_, close

    def _forward(self, layer: str, fn, *args):
        open_, close = self._bracket(layer)
        open_()
        out = fn(*args)
        close()
        return out

    def _backward(self, layer: str, fn, inp: torch.Tensor, *args):
        """``fn(inp, *args)`` with its backward bracketed (and, for
        ``encode``, its forward timed too)."""
        open_, close = self._bracket(layer)
        inp = _Mark.apply(inp, close)
        return _Mark.apply(fn(inp, *args), open_)

    # -- the wraps ---------------------------------------------------------------

    def _patch(self, module, name: str, wrapper) -> None:
        original = getattr(module, name)
        self._patched.append((module, name, original))
        setattr(module, name, wrapper(original))

    def install(self) -> None:
        from nersemble_tpu_torch.engine import trainer as trainer_mod
        from nersemble_tpu_torch.models import field as field_mod
        from nersemble_tpu_torch.models import nersemble as model_mod
        from nersemble_tpu_torch.ops import fused_mlp as mlp_mod

        timers = self

        def adam(orig):
            def wrapped(params, *args, **kwargs):
                n = sum(p.numel() for p in params.parameters() if p.grad is not None)
                timers.bound_ms["adam"] += roofline.adam_bound_ms(n)
                return timers._forward("adam", lambda: orig(params, *args, **kwargs))
            return wrapped

        def quad(orig):
            def wrapped(table, *args):
                if not torch.is_grad_enabled():
                    return orig(table, *args)
                timers._flush_rows()  # a new step's table
                return timers._backward(
                    "encode_bwd",
                    lambda t, *a: timers._forward("encode_fwd", orig, t, *a),
                    table, *args)
            return wrapped

        def encode(orig, blended):
            def wrapped(quad_table, x, *args):
                if not torch.is_grad_enabled():
                    return orig(quad_table, x, *args)
                timers._touch(x)
                timers._encode_samples += x.shape[0]
                timers._code_cols = args[0].shape[1] if blended else 0
                return timers._backward(
                    "encode_bwd",
                    lambda q, *a: timers._forward("encode_fwd", orig, q, *a),
                    quad_table, x, *args)
            return wrapped

        def mlp(orig):
            def wrapped(params, x, *args):
                if not torch.is_grad_enabled():
                    return orig(params, x, *args)
                shapes = [tuple(layer.w.shape) for layer in params.layers]
                timers.bound_ms["mlp_bwd"] += roofline.mlp_bwd_bound_ms(x.shape[0], shapes)
                return timers._backward("mlp_bwd", lambda xx, *a: orig(params, xx, *a),
                                        x, *args)
            return wrapped

        def gather(orig):
            def wrapped(weight, index):
                if not torch.is_grad_enabled():
                    return orig(weight, index)
                return timers._backward("time_code_bwd", orig, weight, index)
            return wrapped

        self._patch(trainer_mod, "fused_adam_update", adam)
        self._patch(field_mod, "build_quad_table", quad)
        self._patch(field_mod, "hash_encode_blended", lambda o: encode(o, True))
        self._patch(field_mod, "hash_encode", lambda o: encode(o, False))
        self._patch(mlp_mod, "fused_mlp_apply", mlp)
        self._patch(model_mod, "_gather_rows", gather)

    def uninstall(self) -> None:
        for module, name, original in reversed(self._patched):
            setattr(module, name, original)
        self._patched.clear()
        self._flush_rows()

    # -- the encode's distinct rows ----------------------------------------------

    def _touch(self, x: torch.Tensor) -> None:
        with torch.no_grad():
            if self._touched is None:
                self._touched = torch.zeros(self.lv["entries"], dtype=torch.bool,
                                            device=x.device)
            rows, _ = corner_rows(x.detach(), self.lv)
            self._touched[rows.reshape(-1)] = True

    def _flush_rows(self) -> None:
        if self._touched is not None:
            self._rows.append(self._touched.sum())
            self._touched.zero_()

    # -- results -------------------------------------------------------------------

    def totals(self) -> Dict[str, Dict[str, float]]:
        """Per layer: device ms over every closed bracket, the bound's ms
        and the number of brackets."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rows = float(sum(float(r) for r in self._rows))
        enc = roofline.encode_bound_ms(self._encode_samples, rows, self.lv,
                                       self._code_cols)
        self.bound_ms["encode_fwd"] = self.bound_ms["encode_bwd"] = enc
        out = {}
        for layer, pairs in self.pairs.items():
            closed = [(a, b) for a, b in pairs if a is not None and b is not None]
            if self.device.type == "cuda":
                ms = sum(a.elapsed_time(b) for a, b in closed)
            else:
                ms = sum(1e3 * (b - a) for a, b in closed)
            out[layer] = {"ms": ms, "bound_ms": float(self.bound_ms.get(layer, 0.0)),
                          "calls": len(closed)}
        return out
