"""The traced window and the reduction of its ``torch.profiler`` traces to
what the per-layer metrics read.

A traced run makes two passes over requests of the cell's own traffic:

* the timeline: the mix's ``trace_requests`` requests with the profiler
  recording device activity only (kernels, copies, memsets and the CUDA
  calls that launched them), which costs the host little.  It gives the
  device's busy seconds (the union of the operations' intervals), the
  kernels launched, and the idle gaps;
* the attribution: one more request with host operators and their input
  shapes recorded as well, which slows the host several times over but
  leaves each kernel's device time as it was.  It gives the device time
  inside the benchmark's spans and of each call of the program's ops.

Spans are the benchmark's own: forward hooks on the modules
:func:`system.models_of` names (``unet``, ``vae_decode``) and a span a
request, kept as host timestamps (``time.time_ns``, the clock the
profiler's events are on) and, in the attribution pass, also as
``record_function`` ranges.  A device operation belongs to a span, or to a
call of one of the program's ops (``sdt_torch::...``), when the host moment
it was launched falls inside it: the CUDA call with its correlation id.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "port_bench."
#: the program's hand-written kernels are ops of this namespace
OP_PREFIX = "sdt_torch::"
_COPIES = ("Memcpy", "Memset")


class Spans:
    """Forward hooks around the named modules: each forward's host interval
    (and, with ``ranges``, a ``record_function`` range around it), the
    forwards and their batch rows."""

    def __init__(self, modules: Dict[str, object], *, ranges: bool):
        import torch

        self._torch, self.ranges = torch, ranges
        self.calls: Dict[str, int] = defaultdict(int)
        self.rows: Dict[str, int] = defaultdict(int)
        self.intervals: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self._open: List[tuple] = []
        self._handles = []
        for name, module in modules.items():
            self._handles.append(module.register_forward_pre_hook(self._enter(name)))
            self._handles.append(module.register_forward_hook(self._exit))

    def _enter(self, name):
        def hook(module, args):
            rf = None
            if self.ranges:
                rf = self._torch.profiler.record_function(SPAN_PREFIX + name)
                rf.__enter__()
            self._open.append((name, time.time_ns(), rf))
            self.calls[name] += 1
            self.rows[name] += int(args[0].shape[0])
        return hook

    def _exit(self, module, args, output):
        name, t0, rf = self._open.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        self.intervals[name].append((t0, time.time_ns()))

    @contextlib.contextmanager
    def request(self):
        t0 = time.time_ns()
        if self.ranges:
            with self._torch.profiler.record_function(SPAN_PREFIX + "request"):
                yield
        else:
            yield
        self.intervals["request"].append((t0, time.time_ns()))

    def close(self):
        for h in self._handles:
            h.remove()
        self._handles = []


@dataclass
class OpCall:
    name: str
    shapes: list
    dtypes: list
    device_s: float


@dataclass
class Trace:
    """What a traced run's two passes hold, reduced."""

    #: the timeline: its window (first request start to last request end),
    #: the union of its device operations, its kernels and UNet forwards
    window_s: float = 0.0
    busy_s: float = 0.0
    n_kernels: int = 0
    unet_evals: int = 0
    flops: float = 0.0
    #: [name, seconds]: the device operations that took most time, and the
    #: idle gaps summed by the benchmark span the host was in
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)
    #: the attribution: device seconds launched inside each span kind, the
    #: forwards and batch rows of each hooked module, and every call of the
    #: program's ops with its input shapes and the device time it launched
    span_device_s: Dict[str, float] = field(default_factory=dict)
    calls: Dict[str, int] = field(default_factory=dict)
    rows: Dict[str, int] = field(default_factory=dict)
    op_calls: List[OpCall] = field(default_factory=list)


def _split(events):
    host, device = [], []
    for e in events:
        (device if e.device_type().name == "CUDA" else host).append(e)
    return host, device


def _device_ops(host, device, skip=()):
    """(start, end, name, host launch time) of each device operation."""
    launch = {e.correlation_id(): e.start_ns() for e in host
              if e.name().startswith(("cuda", "cu")) and e.correlation_id()}
    op_start = {e.correlation_id(): e.start_ns() for e in host}
    ops = []
    for e in device:
        if e.name() in skip:  # the device side of a user annotation
            continue
        t = launch.get(e.correlation_id())
        if t is None:
            t = op_start.get(e.linked_correlation_id())
        ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), t))
    return ops


def _short(name: str) -> str:
    """A kernel's name without the namespaces and qualifiers that make
    most of a long template name, cut at 160 characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "c10::", "std::"):
        name = name.replace(noise, "")
    return name[:160]


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """Total covered length and the gaps between the merged intervals."""
    total, gaps = 0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


class _Index:
    """Sorted, non-overlapping intervals; which one holds a moment."""

    def __init__(self, intervals):
        self.iv = sorted(intervals)
        self.starts = [s for s, *_ in self.iv]

    def find(self, t) -> Optional[int]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.iv[i][1]:
            return i
        return None


def timeline(trace: Trace, events, spans: Spans) -> None:
    """The timeline pass: busy seconds over the window of its requests,
    kernels, the top operations and the idle gaps by span."""
    host, device = _split(events)
    ops = _device_ops(host, device)
    reqs = spans.intervals["request"]
    w0, w1 = min(s for s, _ in reqs), max(e for _, e in reqs)
    ops = [(max(s, w0), min(e, w1), n, t) for s, e, n, t in ops if e > w0 and s < w1]
    busy, gaps = _union([(s, e) for s, e, _, _ in ops])
    trace.window_s = (w1 - w0) / 1e9
    trace.busy_s = busy / 1e9
    trace.n_kernels = sum(1 for *_, n, _ in ops if not n.startswith(_COPIES))
    trace.unet_evals = spans.calls.get("unet", 0)
    by_name: Dict[str, int] = defaultdict(int)
    for s, e, n, _ in ops:
        by_name[_short(n)] += e - s
    trace.device_ops = [[n, v / 1e9] for n, v in
                        sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    # a gap is charged to the innermost span the host was in at its middle
    kinds = [k for k in ("vae_decode", "unet") if spans.intervals.get(k)]
    index = {k: _Index(spans.intervals[k]) for k in kinds}
    req_index = _Index(reqs)
    by_span: Dict[str, int] = defaultdict(int)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        where = next((f"host in {k} forward" for k in kinds if index[k].find(mid) is not None),
                     None)
        if where is None:
            where = "host in request, outside the UNet and VAE" \
                if req_index.find(mid) is not None else "host between requests"
        by_span[where] += g1 - g0
    trace.idle_gaps = [[n, v / 1e9] for n, v in
                       sorted(by_span.items(), key=lambda kv: -kv[1])[:10]]


def attribution(trace: Trace, events, spans: Spans) -> None:
    """The attribution pass: device seconds inside each span kind, and each
    call of the program's ops with its shapes and device seconds."""
    host, device = _split(events)
    span_names = {SPAN_PREFIX + k for k in spans.intervals}
    ops = _device_ops(host, device, skip=span_names)
    intervals: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    calls = []
    for e in host:
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            intervals[name[len(SPAN_PREFIX):]].append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith(OP_PREFIX):
            calls.append((e.start_ns(), e.start_ns() + e.duration_ns(), name, e.shapes(),
                          list(e.dtypes())))
    for kind, ivs in intervals.items():
        index = _Index(ivs)
        trace.span_device_s[kind] = sum(e - s for s, e, _, t in ops
                                        if t is not None and index.find(t) is not None) / 1e9
    index = _Index(calls)
    call_ns = [0] * len(index.iv)
    for s, e, _, t in ops:
        i = None if t is None else index.find(t)
        if i is not None:
            call_ns[i] += e - s
    trace.op_calls = [OpCall(c[2], c[3], c[4], call_ns[i] / 1e9)
                      for i, c in enumerate(index.iv)]
    trace.calls, trace.rows = dict(spans.calls), dict(spans.rows)
