"""Spans, host reads and kernel timers inside the port, off by default.

One recording per process, switched by ``enable()`` and ended by
``collect()``; nothing else turns it on (no environment variable, no
flag). The port calls three things at its layer boundaries:

- ``span(name)``: a context manager around one unit of work (a condition,
  an outer round, a search evaluation, an LM trial, an assembly, a cost);
- ``read(t, conv)``: the one way the port turns a device tensor into a host
  value (``conv`` is ``bool``, ``float``, ``int``, ``torch.Tensor.cpu``;
  none gives ``t.cpu().numpy()``). On the card every such conversion waits
  for the device, so each one is counted and its wait recorded as a
  ``sync`` span under the span that is open;
- ``kernel(family, device)``: a pair of CUDA events around one launch of a
  hand-written kernel, resolved only in ``collect()``.

Off, ``span`` and ``kernel`` return one shared no-op context and ``read``
converts with one flag check more: no clock is read, nothing is allocated.

On, a span records its name, start and end (``time.perf_counter_ns``), the
index of its parent span and the condition it belongs to (the id that the
``pipeline.condition`` span sets: a condition is this system's request).
While a ``torch.profiler`` is recording, a span also opens
``record_function("span.<name>")``, so the profiler's trace carries the
program's spans on its own clock; ``enable()`` records the offset from
``perf_counter_ns`` to that clock (the Unix epoch, ``time.time_ns``) so that
spans outside a profiled stretch can be laid beside a device trace too.

``collect()`` closes every span still open at that instant, switches the
recording off and returns::

    {"clock": {"profiler_offset_ns": int},   # profiler ns = perf ns + offset
     "spans": {name: {"calls", "total_s", "self_s", "reads"}},
     "reads": int,                            # host reads in all
     "kernels": {family: {"launches", "device_s"}},
     "raw": [(name, start_ns, end_ns, parent, condition), ...]}

``self_s`` is a span's time less what its child spans cover (a ``sync``
span is a child); ``reads`` counts the host reads made inside a span's
calls, nested spans included. A span that ends after ``collect()`` (an
exception that unwinds the program after the recording was taken) is
ignored. The recording is not shared between threads: spans of two
threads at once would nest into one another.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

CONDITION = "pipeline.condition"
SYNC = "sync"
KERNELS = ("kernel1", "kernel2")

_NULL = contextlib.nullcontext()
_rec = None  # the open recording, None while tracing is off


class _Recording:
    def __init__(self):
        self.spans = []  # [name, start_ns, end_ns, parent, condition]
        self.stack = []  # indices of the open spans, innermost last
        self.condition = None
        self.n_conditions = 0
        self.events = {k: [] for k in KERNELS}
        # Profiler time = perf_counter_ns + offset; the narrowest of a few
        # bracketed samples.
        best = None
        for _ in range(5):
            a = time.perf_counter_ns()
            w = time.time_ns()
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, w - (a + b) // 2)
        self.offset_ns = best[1]


class _Span:
    __slots__ = ("rec", "idx", "rf", "outer_condition")

    def __init__(self, rec: _Recording, name: str):
        self.rec = rec
        self.outer_condition = rec.condition
        if name == CONDITION:
            rec.condition = rec.n_conditions
            rec.n_conditions += 1
        parent = rec.stack[-1] if rec.stack else -1
        self.idx = len(rec.spans)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(f"span.{name}")
            self.rf.__enter__()
        rec.stack.append(self.idx)
        rec.spans.append([name, time.perf_counter_ns(), None, parent, rec.condition])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        rec = self.rec
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if rec is not _rec:
            return False
        rec.spans[self.idx][2] = t
        rec.stack.pop()
        rec.condition = self.outer_condition
        return False


def enable() -> None:
    """Start a new recording (dropping one not collected)."""
    global _rec
    _rec = _Recording()


def span(name: str):
    """A context manager that records one span of ``name`` while tracing is
    on, and does nothing while it is off."""
    rec = _rec
    if rec is None:
        return _NULL
    return _Span(rec, name)


def read(t, conv=None):
    """``conv(t)`` (``t.cpu().numpy()`` without ``conv``): a host value of
    the tensor ``t``. While tracing is on, one host read, timed as a
    ``sync`` span."""
    rec = _rec
    if rec is None:
        return t.cpu().numpy() if conv is None else conv(t)
    with _Span(rec, SYNC):
        return t.cpu().numpy() if conv is None else conv(t)


class _Timer:
    __slots__ = ("start", "end", "stream", "out")

    def __init__(self, out: list, device):
        self.out = out
        self.stream = torch.cuda.current_stream(device)
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        self.end.record(self.stream)
        self.out.append((self.start, self.end))
        return False


def kernel(family: str, device):
    """A context manager around one launch of kernel ``family`` on the CUDA
    ``device``: a pair of timing events on its current stream while
    tracing is on, nothing while it is off."""
    rec = _rec
    if rec is None:
        return _NULL
    return _Timer(rec.events[family], device)


def collect() -> dict:
    """End the recording and return it (see the module docstring); ``{}``
    when tracing was off."""
    global _rec
    rec = _rec
    if rec is None:
        return {}
    now = time.perf_counter_ns()
    _rec = None
    spans = rec.spans
    for i in rec.stack:
        spans[i][2] = now
    kernels = {}
    if any(rec.events.values()):
        torch.cuda.synchronize()
    for fam, pairs in rec.events.items():
        kernels[fam] = {"launches": len(pairs), "device_s": sum(a.elapsed_time(b) for a, b in pairs) / 1e3}

    child_ns = [0] * len(spans)
    for name, t0, t1, parent, _ in spans:
        if parent >= 0:
            child_ns[parent] += t1 - t0
    # Host reads inside each span's calls: every sync span counts once for
    # each distinct name on its chain of parents.
    reads = collections.Counter()
    for i, (name, _, _, parent, _) in enumerate(spans):
        if name != SYNC:
            continue
        seen = set()
        while parent >= 0:
            pname = spans[parent][0]
            if pname not in seen:
                seen.add(pname)
                reads[pname] += 1
            parent = spans[parent][3]
    out = {}
    for i, (name, t0, t1, _, _) in enumerate(spans):
        s = out.setdefault(name, {"calls": 0, "total_s": 0.0, "self_s": 0.0, "reads": 0})
        s["calls"] += 1
        s["total_s"] += (t1 - t0) / 1e9
        s["self_s"] += (t1 - t0 - child_ns[i]) / 1e9
    for name, n in reads.items():
        out[name]["reads"] = n
    return {
        "clock": {"profiler_offset_ns": rec.offset_ns},
        "spans": out,
        "reads": out.get(SYNC, {}).get("calls", 0),
        "kernels": kernels,
        "raw": [tuple(s) for s in spans],
    }
