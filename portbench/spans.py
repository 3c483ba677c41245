"""The port's own spans and counts of a traced window, for the readers of
the host layer's metrics.

The port (`pycricodecs_tpu_torch.utils.tracing`) records a span, stamped
in Unix nanoseconds, at each stage of its CRILAYLA path while a profiler
runs; the profiler runs only in the window, so its records are the
window's calls. The reduced trace (trace.py) keeps no base time, so the
records are put on its clock by the offset between each call's root span
and the profiler's own event for the entry point's Python function: the
median over calls, refused (None) where the offsets spread (their
interquartile distance, as the benchmark measures a spread) by more than
MAX_SPREAD_US. The two are paired at their ends: before the root's start
the window's first call also pays the profiler's first visit to the
recorder's code (about 45 us more than the other calls on a CPU), and by
its end every call runs warm code. A call the host preempts or collects
garbage in between reads tens of us off; the quartiles ignore it.
`load(ctx)` is None too where the port has no recorder (a commit before
it), dropped records, or recorded another number of calls than the
window made.
"""
from __future__ import annotations

import importlib
import statistics

from portbench.trace import host_label

#: a job's root span and the Python function that opens it
ROOTS = {"compress": ("crilayla.compress",
                      "models/crilayla.py:compress_members"),
         "extract": ("crilayla.decompress",
                     "models/crilayla.py:decompress_batch")}
#: the most the per-call offsets between the two clocks may spread, us
MAX_SPREAD_US = 50.0
#: the host layer's own stages of a compress call: the members' join and
#: copy, the streams' slices and blob assembly, the wrapper's preparation
HOST_STAGES = ("crilayla.pack", "crilayla.collect", "c2.prepare")


def port_records():
    """The port's records, or None where it has no recorder or dropped
    some."""
    try:
        tracing = importlib.import_module(
            "pycricodecs_tpu_torch.utils.tracing")
    except ImportError:
        return None
    if tracing.dropped():
        return None
    return tracing.records()


def merged(intervals) -> list:
    """Sorted disjoint [(lo, hi)] covering the same points."""
    out = []
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def overlap(a, b) -> float:
    """Length of the intersection of two sets of intervals."""
    a, b = merged(a), merged(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class Spans:
    """The window's records on the reduced trace's clock (us)."""

    def __init__(self, records: list, ref_ns: int, offset_us: float,
                 spread_us: float) -> None:
        self.records = records
        self.offset_us, self.spread_us = offset_us, spread_us
        self.ref_ns = ref_ns
        self.children = {}
        for r in records:
            if r.parent is not None:
                self.children.setdefault(r.parent, []).append(r)

    def us(self, ns: int) -> float:
        return (ns - self.ref_ns) / 1e3 - self.offset_us

    def interval(self, r) -> tuple:
        return self.us(r.start_ns), self.us(r.end_ns)

    def own(self, r) -> list:
        """[(lo, hi)] of record r's span less its children's."""
        out = []
        lo, hi = self.interval(r)
        for c in sorted(self.children.get(r.id, ()),
                        key=lambda c: c.start_ns):
            clo, chi = self.interval(c)
            if clo > lo:
                out.append((lo, min(clo, hi)))
            lo = max(lo, chi)
        if hi > lo:
            out.append((lo, hi))
        return out

    def self_intervals(self, names) -> list:
        """[(lo, hi)] of the spans named `names`, less their children."""
        return [iv for r in self.records if r.name in names
                for iv in self.own(r)]

    def count(self, key: str) -> int:
        """The count `key` summed over every span."""
        return sum(r.counts.get(key, 0) for r in self.records)


def offsets(records, trace, calls: int, job: str = "compress"):
    """(the first root's start ns, each call's clock offset in us: its
    root's end, from that start, less its function's end on the trace),
    or None where either side has another number of calls than `calls`."""
    root, function = ROOTS[job]
    roots = sorted((r for r in records
                    if r.parent is None and r.name == root),
                   key=lambda r: r.start_ns)
    ends = [hi for name, _, hi in sorted(trace.host, key=lambda h: h[1])
            if host_label(name)[0] == function]
    if not roots or len(roots) != calls or len(ends) != calls:
        return None
    ref = roots[0].start_ns
    return ref, [(r.end_ns - ref) / 1e3 - hi for r, hi in zip(roots, ends)]


def spread(xs: list) -> float:
    """The interquartile distance (`statistics.quantiles`, n=4); 0 for
    fewer than two values."""
    if len(xs) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(xs, n=4)
    return q3 - q1


def from_records(records, trace, calls: int, job: str = "compress"):
    """`Spans` of `records` on `trace`'s clock, or None (module doc)."""
    if records is None or trace is None:
        return None
    found = offsets(records, trace, calls, job)
    if found is None:
        return None
    ref, xs = found
    if spread(xs) > MAX_SPREAD_US:
        return None
    return Spans(list(records), ref, statistics.median(xs), spread(xs))


def load(ctx, job: str = "compress"):
    """The window's `Spans` of a traced run's `ctx`, or None; read once
    and kept on ctx for the other readers."""
    key = "_spans_" + job
    if key not in ctx.__dict__:
        ctx.__dict__[key] = from_records(port_records(), ctx.trace,
                                         ctx.calls, job)
    return ctx.__dict__[key]
