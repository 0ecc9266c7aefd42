"""Spans and counters of the port, totalled per calibration.

``recording()`` opens a Recorder for one run (``VicalibEngine._run`` opens
one per calibration).  Inside it ``span(name)`` adds the host time of its
block and a count of 1 to the recorder's total for ``name``, and
``count(name, k)`` adds ``k`` to a counter.  Outside a recording both
record nothing; a span still times its block (``.s``) for its caller.

While a torch profiler runs, a span also opens a host range of that name
on the profiler's timeline, on the same clock as the device's events; with
no profiler running it makes no torch call.  The range is a function-scope
one (``torch._C._profiler._RecordFunctionFast``, shown like an operator),
not a ``torch.profiler.record_function`` annotation: the profiler mirrors
an annotation on the device's timeline over the kernels launched inside
it, and a reading of the trace that takes every device event but its own
annotations for device work would count those mirrors as busy time.  A
span times the host only: it synchronises nothing, so device time shows
in a span only where the code inside it already waits for the device
(``vicalib.lm.wait``).

Every name starts with ``vicalib.``.  The result log (-output_log_file)
carries the totals as one row per span and per counter
(:meth:`Recorder.rows`).
"""
from __future__ import annotations

import contextlib
import time

import torch._C._profiler as _c_profiler
import torch.autograd.profiler as _autograd_profiler

_current = None          # the innermost open Recorder


class Recorder:
    """The totals of one recording: ``spans[name] = [n, ns]`` and
    ``counts[name] = total``."""

    def __init__(self):
        self.spans = {}
        self.counts = {}

    def n(self, name) -> int:
        return self.spans.get(name, (0, 0))[0]

    def seconds(self, name) -> float:
        return self.spans.get(name, (0, 0))[1] / 1e9

    def count(self, name) -> int:
        return self.counts.get(name, 0)

    def add(self, other: "Recorder"):
        for name, (n, ns) in other.spans.items():
            tot = self.spans.setdefault(name, [0, 0])
            tot[0] += n
            tot[1] += ns
        for name, k in other.counts.items():
            self.counts[name] = self.counts.get(name, 0) + k

    def rows(self) -> list:
        """``span <name>: n=<count> s=<seconds>`` and ``count <name>:
        <total>`` rows, sorted by name."""
        rows = [(name, "span %s: n=%d s=%.6f" % (name, n, ns / 1e9))
                for name, (n, ns) in self.spans.items()]
        rows += [(name, "count %s: %d" % (name, k))
                 for name, k in self.counts.items()]
        return [row for _, row in sorted(rows)]


@contextlib.contextmanager
def recording():
    """A fresh Recorder for the block; an enclosing recording receives its
    totals when the block ends."""
    global _current
    outer = _current
    rec = _current = Recorder()
    try:
        yield rec
    finally:
        _current = outer
        if outer is not None:
            outer.add(rec)


class span:
    """``with span(name) as sp:`` times the block on the host clock;
    ``sp.s`` holds its seconds once it has ended."""

    __slots__ = ("name", "ns", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0
        self._rf = None

    @property
    def s(self) -> float:
        return self.ns / 1e9

    def __enter__(self):
        # torch's own flag of a running profiler: a module global, not a call
        if _autograd_profiler._is_profiler_enabled:
            self._rf = _c_profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.ns = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        rec = _current
        if rec is not None:
            tot = rec.spans.get(self.name)
            if tot is None:
                rec.spans[self.name] = [1, self.ns]
            else:
                tot[0] += 1
                tot[1] += self.ns
        return False


def count(name: str, k: int = 1):
    """Add ``k`` to the open recording's counter ``name``."""
    rec = _current
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + k
