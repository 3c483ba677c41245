"""Spans and counters of the port's host path, recorded only while a
torch.profiler session runs in the calling thread (`parallel.trace`, or
any `torch.profiler.profile`; torch's profiler state is per thread).

    with tracing.span("crilayla.pack"):
        ...
        tracing.count("host_bytes", n)

With no profiler running, a span or a count costs one check of the
profiler's state: it enters no `record_function`, reads no clock and
keeps nothing. With one running, each span enters
`torch.profiler.record_function(name)`, so that it sits in the profiler's
trace as a `user_annotation` (and a `gpu_user_annotation` around the
kernels it launched), and appends a `Record` when it ends: its name,
start and end in Unix nanoseconds (`time.time_ns()`, the clock the
profiler stamps its events with: a Chrome trace's `ts` plus
`baseTimeNanoseconds` / 1000), its parent span, its call (the id of the
outermost open span of its thread, shared by every span of one entry
point's call) and its counts. `count` adds to the innermost open span of
its thread. At most CAP records are kept; `dropped()` counts those left
out. `records()` reads them, `reset()` clears them, `summary()` folds them
by name.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import _profiler_enabled

#: records kept before `dropped()` counts the rest
CAP = 1 << 17

_records: list = []
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


class Record(NamedTuple):
    name: str
    id: int
    parent: int | None
    call: int
    start_ns: int
    end_ns: int
    counts: dict


class _Off:
    """The span of a process with no profiler running: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def enabled() -> bool:
    """Whether spans and counts are recorded now (a profiler runs): the
    check a caller makes before computing a count that costs work."""
    return _profiler_enabled()


class span:
    """A span named `name` with initial `counts`; a context manager."""
    __slots__ = ("name", "counts", "id", "parent", "call", "start_ns",
                 "_rf")

    def __new__(cls, name: str, **counts):
        if not _profiler_enabled():
            return _OFF
        self = object.__new__(cls)
        self.name, self.counts = name, counts
        return self

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, self.id
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self.start_ns = time.time_ns()
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        global _dropped
        self._rf.__exit__(*exc)
        end = time.time_ns()
        _local.stack.pop()
        if len(_records) < CAP:
            _records.append(Record(self.name, self.id, self.parent,
                                   self.call, self.start_ns, end,
                                   self.counts))
        else:
            _dropped += 1
        return False


def count(name: str, n: int) -> None:
    """Add n to the count `name` of this thread's innermost open span."""
    if not _profiler_enabled():
        return
    stack = getattr(_local, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + int(n)


def records() -> list:
    """The records kept since the last `reset()`, in the order their
    spans ended."""
    return list(_records)


def dropped() -> int:
    """Records left out since the last `reset()` (over CAP)."""
    return _dropped


def reset() -> None:
    global _dropped
    _records.clear()
    _dropped = 0


def self_ns(recs) -> dict:
    """{record id: its duration less the part its child spans cover}."""
    children = {}
    for r in recs:
        if r.parent is not None:
            children.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
    out = {}
    for r in recs:
        covered, end = 0, r.start_ns
        for lo, hi in sorted(children.get(r.id, ())):
            lo, hi = max(lo, end), min(hi, r.end_ns)
            if hi > lo:
                covered += hi - lo
                end = hi
        out[r.id] = r.end_ns - r.start_ns - covered
    return out


def summary(recs=None) -> dict:
    """{"records", "dropped", "by_name": {name: {"count", "total_s",
    "self_s", "counts"}}} of `recs` (default: `records()`), the counts
    summed over the name's spans."""
    recs = records() if recs is None else list(recs)
    own = self_ns(recs)
    by = {}
    for r in recs:
        s = by.setdefault(r.name, {"count": 0, "total_s": 0.0,
                                   "self_s": 0.0, "counts": {}})
        s["count"] += 1
        s["total_s"] += (r.end_ns - r.start_ns) / 1e9
        s["self_s"] += own[r.id] / 1e9
        for k, v in r.counts.items():
            s["counts"][k] = s["counts"].get(k, 0) + v
    return {"records": recs, "dropped": dropped(), "by_name": by}
