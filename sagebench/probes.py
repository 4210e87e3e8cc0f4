"""The harness's own spans around its calls into the program's layers.

``Probes.wrap`` replaces a module's function for the life of a ``with``
block: each call is timed by CUDA events on the card (the host clock on
the CPU, where the tests run), and opens a ``record_function`` span of
the name, so that a device trace can say what the host was doing in each
of the device's idle gaps.  Nothing inside the program is changed.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch
from torch.profiler import record_function

SPAN_PREFIX = "sb:"


class Stamp:
    """A point on the device's stream (a CUDA event) or the host clock."""

    def __init__(self, device: torch.device):
        if device.type == "cuda":
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record()
        else:
            self.ev, self.t = None, time.perf_counter()

    def ms_to(self, later: "Stamp") -> float:
        if self.ev is not None:
            return self.ev.elapsed_time(later.ev)
        return (later.t - self.t) * 1e3


def span(name: str):
    """A host span of the harness, seen by the device trace."""
    return record_function(SPAN_PREFIX + name)


class Probes:
    def __init__(self, device: torch.device):
        self.device = device
        self.calls: Dict[str, List] = defaultdict(list)   # name -> stamps
        self._stack = contextlib.ExitStack()

    def wrap(self, module, attr: str, name: str):
        fn = getattr(module, attr)

        def probed(*a, **kw):
            with span(name):
                start = Stamp(self.device)
                val = fn(*a, **kw)
                self.calls[name].append((start, Stamp(self.device)))
            return val

        setattr(module, attr, probed)
        self._stack.callback(setattr, module, attr, fn)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._stack.close()

    def mark(self) -> Dict[str, int]:
        """How many calls each probe has seen (a unit's first index)."""
        return {k: len(v) for k, v in self.calls.items()}

    def ms(self, name: str, since: Dict[str, int],
           until: Dict[str, int]) -> List[float]:
        """Each call's ms between two marks (call synchronize first)."""
        return [s.ms_to(e) for s, e in
                self.calls[name][since.get(name, 0):until.get(name, 0)]]

    def gaps_ms(self, first: str, then: str, since: Dict[str, int],
                until: Dict[str, int]) -> List[float]:
        """ms from the end of each call of ``first`` to the start of the
        matching call of ``then`` (the backward between the forward and
        the optimizer)."""
        a = self.calls[first][since.get(first, 0):until.get(first, 0)]
        b = self.calls[then][since.get(then, 0):until.get(then, 0)]
        return [x[1].ms_to(y[0]) for x, y in zip(a, b)]
