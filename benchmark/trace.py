"""The traced run's records: the profiler's device operations and host
ranges over the traced window, read into plain lists that the per-layer
metric readers (``metrics/<name>.py``) and the breakdown take.

Ranges are ``torch.profiler.record_function`` spans named ``bench.*``,
opened by the harness around its calls into the program (and by its hooks
on the program's modules); nothing inside the program is touched.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

PREFIX = "bench."


class Span:
    """A ``record_function`` range opened and closed by hand (for module
    hooks)."""

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def open(self, *_):
        self._rf = torch.autograd.profiler.record_function(PREFIX + self.name)
        self._rf.__enter__()

    def close(self, *_):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None


def span(name: str):
    return torch.autograd.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def traced(record: dict):
    """Profile the block (CPU and CUDA); on exit fill ``record`` with the
    window's ``kernels`` (name, start ns, duration ns, launching thread or
    None, launch ns or None), ``ranges`` (name, start ns, end ns, thread),
    ``cpu_ops`` (name, start ns, end ns, thread), ``window_ns`` and
    ``main_thread``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        with span("window"):
            yield
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    read_events(prof.profiler.kineto_results.events(), record)
    record["read_s"] = time.perf_counter() - t0


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def read_events(events, record: dict) -> None:
    launches = {}
    kernels, ranges, cpu_ops = [], [], []
    for e in events:
        name = e.name()
        if _is_device(e):
            if name.startswith(PREFIX) or name.startswith("ProfilerStep") \
                    or e.is_user_annotation():
                continue
            kernels.append([name, e.start_ns(), e.duration_ns(),
                            e.correlation_id()])
            continue
        s, d, th = e.start_ns(), e.duration_ns(), e.start_thread_id()
        if name.startswith(PREFIX):
            ranges.append((name[len(PREFIX):], s, s + d, th))
        else:
            cpu_ops.append((name, s, s + d, th))
            if name.startswith("cu"):   # the runtime's and driver's calls
                launches[e.correlation_id()] = (th, s)
    win = [r for r in ranges if r[0] == "window"]
    if not win:
        raise RuntimeError("the profiler recorded no window range")
    w0, w1, main = win[0][1], win[0][2], win[0][3]
    out = []
    for name, s, d, cid in kernels:
        th, ls = launches.get(cid, (None, None))
        out.append((name, s, d, th, ls))
    if not out:
        raise RuntimeError("the profiler recorded no device operation")
    record.update(kernels=out, ranges=ranges, cpu_ops=cpu_ops,
                  window=(w0, w1), window_ns=w1 - w0, main_thread=main)


# ------------------------------------------------------------- reductions
def intervals(kernels, w0, w1):
    """The device's busy intervals (a union), clipped to [w0, w1]."""
    merged = []
    for s, e in sorted((k[1], k[1] + k[2]) for k in kernels):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_ns(record) -> int:
    w0, w1 = record["window"]
    return sum(e - s for s, e in intervals(record["kernels"], w0, w1))


def device_ns(record, match) -> int:
    """Device time of the operations whose name ``match`` accepts."""
    return sum(k[2] for k in record["kernels"] if match(k[0]))


def in_ranges(t: int, ranges) -> bool:
    return any(s <= t <= e for s, e in ranges)


def range_list(record, name):
    return [(s, e) for n, s, e, _ in record["ranges"] if n == name]


def breakdown(record, n=10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps summed by the innermost harness range (and host operation) that
    covered them on the main thread."""
    by_name = defaultdict(int)
    for k in record["kernels"]:
        by_name[k[0][:120]] += k[2]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    w0, w1 = record["window"]
    busy = intervals(record["kernels"], w0, w1)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if w1 > prev:
        gaps.append((prev, w1))
    main = record["main_thread"]
    spans = _innermost([r for r in record["ranges"]
                        if r[3] == main and r[0] != "window"], gaps)
    host = _innermost([o for o in record["cpu_ops"] if o[3] == main], gaps)
    by_gap = defaultdict(int)
    for (s, e), r, o in zip(gaps, spans, host):
        label = r[0] if r else "outside"
        if o:
            label += " / " + o[0][:60]
        by_gap[label] += e - s
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v / 1e9] for k, v in ops],
            "idle_gaps": [[k, v / 1e9] for k, v in idle]}


def _innermost(items, gaps):
    """For each gap (in time order), the innermost of the nested host
    intervals ``items`` (name, start, end, thread) covering its midpoint,
    or None: one sweep over both."""
    items = sorted(items, key=lambda r: (r[1], -r[2]))
    out, stack, j = [], [], 0
    for s, e in gaps:
        mid = (s + e) // 2
        while j < len(items) and items[j][1] <= mid:
            while stack and stack[-1][2] < items[j][1]:
                stack.pop()
            stack.append(items[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out
