"""The device trace of a traced run, read from ``torch.profiler``.

A traced run profiles its first few units of work (steps or requests)
and reads from the trace: the device's busy time as the union of its
operations' intervals (kernels, copies, sets) over the traced window, the
time of each kernel by name, and the idle gaps, each put down to the
innermost harness span (``probes.span``) open on the host when the gap
began.  The window runs from the first harness unit span's start to the
later of the last one's end and the last device operation's end.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from sagebench.probes import SPAN_PREFIX

TOP = 10
NAME_CHARS = 120


def _ns(ev) -> Tuple[int, int]:
    start = ev.start_ns() if hasattr(ev, "start_ns") else ev.start_us() * 1000
    dur = (ev.duration_ns() if hasattr(ev, "duration_ns")
           else ev.duration_us() * 1000)
    return start, start + dur


def _annotation(ev) -> bool:
    """A user annotation mirrored on the device's timeline, not an op."""
    if hasattr(ev, "is_user_annotation"):
        return ev.is_user_annotation()
    return "annotation" in str(ev.activity_type()).lower()


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


class TraceSummary:
    def __init__(self, ops, spans, unit: str):
        units = [(s, e) for n, s, e in spans if n == unit]
        self.ops = ops
        if not units:
            self.window_s = self.busy_s = 0.0
            self.busy, self.lo, self.hi = [], 0, 0
            self.spans = []
            return
        lo = min(s for s, _ in units)
        hi = max([e for _, e in units] + [e for _, _, e in ops])
        busy = _union([(max(s, lo), min(e, hi)) for _, s, e in ops
                       if e > lo and s < hi])
        self.lo, self.hi, self.busy, self.spans = lo, hi, busy, spans
        self.window_s = (hi - lo) / 1e9
        self.busy_s = sum(e - s for s, e in busy) / 1e9

    def kernel_s(self, pattern: str) -> float:
        """Seconds of the device operations whose name matches."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.ops if rx.search(n)) / 1e9

    def top_ops(self) -> List[List]:
        by: Dict[str, int] = defaultdict(int)
        for n, s, e in self.ops:
            by[n[:NAME_CHARS]] += e - s
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        """Idle seconds by the innermost harness span open at each gap's
        start, largest first (the harness's spans nest on one thread)."""
        by: Dict[str, int] = defaultdict(int)
        edges = [self.lo] + [x for se in self.busy for x in se] + [self.hi]
        spans = sorted((s, e, n) for n, s, e in self.spans)
        stack: List[Tuple[int, int, str]] = []
        i = 0
        for gs, ge in zip(edges[::2], edges[1::2]):
            if ge <= gs:
                continue
            while i < len(spans) and spans[i][0] <= gs:
                while stack and stack[-1][1] <= spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] <= gs:
                stack.pop()
            by[stack[-1][2] if stack else "(no harness span)"] += ge - gs
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


class DeviceTrace:
    """``torch.profiler`` over the first units of a traced run."""

    def __init__(self, enabled: bool, units: int, unit_span: str):
        self.enabled, self.units, self.unit = enabled, units, unit_span
        self.prof: Optional[profile] = None
        self.stopped: Optional[profile] = None
        self.traced = 0

    def begin(self):
        if self.enabled and self.prof is None and not self.traced:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()

    def unit_done(self) -> bool:
        """After each unit: stop once ``units`` have been traced; True
        when this unit was the last traced."""
        if self.prof is None:
            return False
        self.traced += 1
        if self.traced >= self.units:
            self.end()
            return True
        return False

    def end(self):
        """Stop the profiler; the trace is read by ``read`` later, after
        the window."""
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.stopped, self.prof = self.prof, None

    def read(self) -> Optional[TraceSummary]:
        if self.stopped is None:
            return None
        ops, spans = [], []
        for ev in self.stopped.profiler.kineto_results.events():
            name = ev.name()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if not _annotation(ev):
                    ops.append((name, *_ns(ev)))
            elif name.startswith(SPAN_PREFIX):
                spans.append((name[len(SPAN_PREFIX):], *_ns(ev)))
        self.stopped = None
        return TraceSummary(ops, spans, self.unit)
