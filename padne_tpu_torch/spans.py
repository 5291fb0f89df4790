"""One span log for the whole port: the stages of a solve, timed on the
host and, under a running torch.profiler, on the profiler's clock too.

`span(name)` is a nestable context manager (a stack per thread).  On
exit it appends one `Record` to the process-wide, bounded `LOG`: its
name, depth, start (time.perf_counter()), seconds, self seconds (less
its child spans) and whether a profiler was recording at its entry.
Its `.seconds` is what the `stats=` dicts of the solve path report.

There is no switch.  Off the profiler a span costs two clock reads and
one append, and never synchronises a device.  When torch.profiler is
recording at entry, the span also opens `record_function(name)`, so
its interval lies on the profiler's timeline around the operations and
kernel launches it made: a device idle gap in a trace falls inside the
innermost span that was running.

Rules for a span's place: never inside code a CUDA graph captures (the
CG iteration, ops.cg's `body`), never on a path the host runs once per
CG iteration; stages only, a few dozen a request.

`recent(top, count)` sums the last `count` unprofiled top-level
occurrences of each name in `top`, and every span nested in them, by
name: the reader of the benchmark's per-layer metrics.
"""

from __future__ import annotations

import collections
import itertools
import sys
import threading
import time
from typing import NamedTuple


class Record(NamedTuple):
    name: str
    depth: int            # 0: top level
    start: float          # time.perf_counter() at entry
    seconds: float
    self_seconds: float   # seconds less the child spans'
    profiled: bool        # a torch profiler was recording at entry
    top: int              # serial number of its top-level span


LOG: collections.deque = collections.deque(maxlen=2**16)
_local = threading.local()
_serial = itertools.count()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _profiling() -> bool:
    """Whether a torch profiler is recording (none can be before torch's
    profiler module was imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return bool(prof is not None and prof._is_profiler_enabled)


class span:
    """with span("schur.pass") as sp: ...; then sp.seconds."""

    __slots__ = ("name", "seconds", "_t0", "_child", "_depth", "_top",
                 "_annotation")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "span":
        stack = _stack()
        self._depth = len(stack)
        self._top = stack[0]._top if stack else next(_serial)
        self._child = 0.0
        self._annotation = None
        if _profiling():
            from torch.profiler import record_function

            self._annotation = record_function(self.name)
            self._annotation.__enter__()
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        stack = _stack()
        stack.pop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        if stack:
            stack[-1]._child += self.seconds
        LOG.append(Record(self.name, self._depth, self._t0, self.seconds,
                          self.seconds - self._child,
                          self._annotation is not None, self._top))


def recent(top, count: int) -> dict:
    """{name: (calls, seconds, self seconds)} over the last `count`
    unprofiled top-level occurrences of each name in `top` and every
    span nested in them."""
    log = list(LOG)
    left = dict.fromkeys(top, count)
    chosen = set()
    for r in reversed(log):
        if r.depth == 0 and not r.profiled and left.get(r.name, 0) > 0:
            left[r.name] -= 1
            chosen.add(r.top)
    out = {}
    for r in log:
        if r.top in chosen:
            calls, s, own = out.get(r.name, (0, 0.0, 0.0))
            out[r.name] = (calls + 1, s + r.seconds, own + r.self_seconds)
    return out
