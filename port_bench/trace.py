"""Spans, kernel shapes and device activity of a traced run (``--trace 1``).

Spans come from the benchmark's own wrappers around module attributes of
the program: each wrapped call runs between two ``torch.cuda.synchronize()``
and adds its host time to its span's total (the program itself has no
spans). While a profiled stretch is open, every span also opens a
``torch.profiler.record_function`` named ``span.<key>`` and every kernel
wrapper records the least time of the launch it makes (``roofline.py``).
A stretch is profiled with CPU and CUDA activity and reduced at once to
device busy time, device time per kernel family, the longest idle gaps
labelled with the host span that was open, and the device operations that
took most time.
"""

from __future__ import annotations

import collections
import time

import torch

# Kernel families, by a part of the CUDA kernel's name.
FAMILIES = {"kernel1": "damped_solve_kernel", "kernel2": "pcg_kernel"}


class Trace:
    """``spans``: [(module, attribute, key)]; ``kernels``: [(module,
    attribute, family, least_seconds(*args))] for the wrappers that launch
    one kernel per call."""

    def __init__(self, spans, kernels):
        self.span_targets = spans
        self.kernel_targets = kernels
        self.active = False
        self.span_s = collections.Counter()
        self.span_calls = collections.Counter()
        self.launch_bounds = collections.defaultdict(list)
        self.stretches = []
        self._originals = []
        self._prof = None
        self._stretch_rf = None
        # Host time spent starting, stopping and reducing the profiler; the
        # drivers take it out of the window.
        self.overhead_s = 0.0

    def install(self):
        for mod, name, key in self.span_targets:
            self._patch(mod, name, self._span(getattr(mod, name), key))
        for mod, name, family, least in self.kernel_targets:
            self._patch(mod, name, self._launch(getattr(mod, name), family, least))

    def uninstall(self):
        for mod, name, fn in reversed(self._originals):
            setattr(mod, name, fn)
        self._originals = []

    def _patch(self, mod, name, fn):
        self._originals.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def _span(self, fn, key):
        def wrapper(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if self._prof is not None:
                with torch.profiler.record_function(f"span.{key}"):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.span_s[key] += time.perf_counter() - t
            self.span_calls[key] += 1
            return out
        return wrapper

    def _launch(self, fn, family, least):
        def wrapper(*args, **kwargs):
            if self.active and self._prof is not None:
                self.launch_bounds[family].append(least(*args, **kwargs))
            return fn(*args, **kwargs)
        return wrapper

    @property
    def profiling(self) -> bool:
        return self._prof is not None

    def begin_stretch(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t = time.perf_counter()
        self.launch_bounds.clear()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._stretch_rf = torch.profiler.record_function("bench.stretch")
        self._stretch_rf.__enter__()
        self.overhead_s += time.perf_counter() - t

    def end_stretch(self, label: str):
        torch.cuda.synchronize()
        self._stretch_rf.__exit__(None, None, None)
        t = time.perf_counter()
        prof, self._prof = self._prof, None
        prof.stop()
        self.stretches.append(reduce_stretch(prof.profiler.kineto_results.events(), label, dict(self.launch_bounds)))
        self.launch_bounds.clear()
        self.overhead_s += time.perf_counter() - t


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_stretch(events, label: str, launch_bounds: dict) -> dict:
    """Busy time, per-family device time, idle gaps and top operations of
    one profiled stretch (``events``: the profiler's kineto events); times
    in seconds."""
    from torch.autograd import DeviceType

    cpu, dev = [], []
    for e in events:
        item = (e.start_ns(), e.end_ns(), e.name())
        if e.device_type() == DeviceType.CPU:
            cpu.append(item)
        elif e.device_type() == DeviceType.CUDA and not item[2].startswith(("span.", "bench.", "ProfilerStep")):
            dev.append(item)
    stretch = [(a, b) for a, b, name in cpu if name == "bench.stretch"]
    if len(stretch) != 1:
        raise RuntimeError(f"profiled stretch {label}: {len(stretch)} stretch markers")
    t0, t1 = stretch[0]
    host_spans = sorted((a, b, name[5:]) for a, b, name in cpu if name.startswith("span."))
    device = [(max(a, t0), min(b, t1), name) for a, b, name in dev]
    device = [d for d in device if d[1] > d[0]]
    busy = _merge([(a, b) for a, b, _ in device])
    families = {}
    for fam, part in FAMILIES.items():
        durs = [b - a for a, b, name in device if part in name]
        bounds = launch_bounds.get(fam, [])
        families[fam] = {"events": len(durs), "device_s": sum(durs) / 1e9, "launches": len(bounds),
                         "least_s_mean": (sum(bounds) / len(bounds)) if bounds else 0.0}
    by_name = collections.Counter()
    for a, b, name in device:
        by_name[name] += (b - a) / 1e9
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = 0.5 * (a + b)
            inside = [name for s, e, name in host_spans if s <= mid <= e]
            gaps.append((inside[-1] if inside else "host_loop", (b - a) / 1e9))
    return {"label": label, "length_s": (t1 - t0) / 1e9, "busy_s": sum(b - a for a, b in busy) / 1e9,
            "families": families, "top_ops": by_name.most_common(10), "gaps": sorted(gaps, key=lambda g: -g[1])[:10]}


def summary(trace: Trace) -> dict:
    """Stretches merged: busy and length summed, kernel families summed,
    the ten longest gaps and operations over all stretches."""
    fam = {}
    for st in trace.stretches:
        for name, f in st["families"].items():
            acc = fam.setdefault(name, {"events": 0, "device_s": 0.0, "least_s": 0.0, "launches": 0})
            acc["events"] += f["events"]
            acc["device_s"] += f["device_s"]
            acc["launches"] += f["launches"]
            # Records the profiler lost count neither in the time nor in the bound.
            acc["least_s"] += f["events"] * f["least_s_mean"]
    ops = collections.Counter()
    gaps = []
    for st in trace.stretches:
        for name, s in st["top_ops"]:
            ops[name] += s
        gaps += [(f"{g[0]} ({st['label']})", g[1]) for g in st["gaps"]]
    return {
        "stretches": [st["label"] for st in trace.stretches],
        "length_s": sum(st["length_s"] for st in trace.stretches),
        "busy_s": sum(st["busy_s"] for st in trace.stretches),
        "families": fam,
        "top_ops": [[n, s] for n, s in ops.most_common(10)],
        "gaps": [[n, s] for n, s in sorted(gaps, key=lambda g: -g[1])[:10]],
    }
