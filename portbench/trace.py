"""The reduction of a torch.profiler trace of the window to what the
metric readers read: device intervals (kernels, copies, fills) inside the
window, their union (busy time), device time by operation, and the idle
gaps by what the host was doing (the innermost Python function of the
port or of this benchmark that covers a gap's middle, and the innermost
call of any kind there). Arithmetic as in tools/profile_torch_slice.py
(`device_intervals`, `union_us`)."""
from __future__ import annotations

import json
import re

import numpy as np

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OURS = ("pycricodecs_tpu_torch/", "portbench/")


def op_name(name: str, cat: str) -> str:
    """A device operation's name without its argument list: a kernel's
    function name, `Memcpy_HtoD` / `Memcpy_DtoH` / `Memset`."""
    if cat == "gpu_memcpy":
        words = name.split()
        return "Memcpy_" + (words[1] if len(words) > 1 else "")
    if cat == "gpu_memset":
        return "Memset"
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return re.split(r"[(<]", name, maxsplit=1)[0].split("::")[-1] or name


def host_label(name: str) -> tuple:
    """(label, ours) of a python_function event: `models/crilayla.py:f`
    for a function of the port (`portbench/...` of the benchmark), and
    whether it is one of those; `file.py:f` or `builtin:f` otherwise."""
    m = re.match(r"(.*)\(\d+\): (.*)", name)
    if m:
        path, func = m.groups()
        path = path.replace("\\", "/")
        for root in OURS:
            if root in path:
                rel = path.split(root, 1)[1]
                rel = rel if root.startswith("pycricodecs") else root + rel
                return f"{rel}:{func}", True
        return f"{path.rsplit('/', 1)[-1]}:{func}", False
    m = re.match(r"<built-in (?:method|function) (\w+)", name)
    if m:
        return f"builtin:{m.group(1)}", False
    return re.sub(r" at 0x[0-9a-f]+", "", name), False


def union(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        lo = max(lo, end)
        if hi > lo:
            busy += hi - lo
        end = max(end, hi)
    return busy


class Trace:
    """The window of one chrome trace (`export_chrome_trace`), in us."""

    def __init__(self, events: list) -> None:
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("name") == WINDOW]
        if not spans:
            raise ValueError(f"the trace has no {WINDOW} span")
        w = max(spans, key=lambda e: float(e["dur"]))
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w["dur"])
        self.window_s = (self.t1 - self.t0) / 1e6
        self.device = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            lo = max(float(e["ts"]), self.t0)
            hi = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if hi > lo:
                self.device.append((op_name(e["name"], e["cat"]), lo, hi))
        self.busy_s = union((lo, hi) for _, lo, hi in self.device) / 1e6
        host = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e.get("ph") == "X"
                and e.get("cat") == "python_function"
                and float(e["ts"]) < self.t1
                and float(e["ts"]) + float(e["dur"]) > self.t0]
        self.host = host

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def device_seconds(self, match) -> float:
        """Device seconds of the operations whose name `match` accepts."""
        return sum(hi - lo for name, lo, hi in self.device
                   if match(name)) / 1e6

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for name, lo, hi in self.device:
            by[name] = by.get(name, 0.0) + (hi - lo) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def gaps(self) -> list:
        """[(lo, hi)] of the window's device idle intervals."""
        out, end = [], self.t0
        for lo, hi in sorted((lo, hi) for _, lo, hi in self.device):
            if lo > end:
                out.append((end, lo))
            end = max(end, hi)
        if self.t1 > end:
            out.append((end, self.t1))
        return out

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host was doing, idle seconds]], the largest first."""
        gaps = self.gaps()
        if not gaps:
            return []
        labels = [host_label(n) for n, _, _ in self.host]
        lo = np.array([h[1] for h in self.host] or [0.0])
        hi = np.array([h[2] for h in self.host] or [0.0])
        ours = np.array([o for _, o in labels] or [False])
        span = hi - lo
        by = {}
        for a, b in gaps:
            mid = (a + b) / 2
            cover = (lo <= mid) & (hi >= mid) if self.host else \
                np.zeros(1, bool)
            label = "(no host function)"
            if cover.any():
                idx = np.flatnonzero(cover)
                inner = idx[np.argmin(span[idx])]
                label = labels[inner][0]
                mine = idx[ours[idx]]
                if len(mine) and not ours[inner]:
                    port = mine[np.argmin(span[mine])]
                    label = f"{labels[port][0]} > {label}"
            by[label] = by.get(label, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]
