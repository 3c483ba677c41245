#!/usr/bin/env python3
"""The port's spans in a traced benchmark run, and what the spans cost.

    python3 tools/span_report.py --workload <cell> --seed <n> \
        --seconds <s> [--out report.json]
    python3 tools/span_report.py --cost

The first form runs one cell as `python3 -m portbench.run --trace 1`
does (portbench.run.run_cell, the same window and result line) and then
reads the port's span records (pycricodecs_tpu_torch.utils.tracing) on
the window's reduced trace (portbench/spans.py): the share of the
window's device-idle time that lies under any span of the port and under
its stage spans (every span but the roots); and for each span name its
per-call time (its self time summed over a call) as the median and
quartiles across the window's calls, with the alignment's offset
spread. Prints the result line, then one JSON line of the report
(also written to --out).

`--cost` times a span on this host's CPU with no profiler running and
under a torch.profiler session (CPU and, where present, CUDA
activities), in ns a span (enter and exit), each the median of five
loops of 20,000 spans, and prints one JSON line.

Both name the device: the card's name and power limit where CUDA is
present. Run from the repository root.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def card_line() -> str:
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def quartiles(xs: list) -> dict:
    out = {"median": statistics.median(xs), "n": len(xs)}
    if len(xs) >= 4:
        q1, _, q3 = statistics.quantiles(xs, n=4)
        out.update(q1=q1, q3=q3)
    return out


def report(ctx) -> dict:
    """The spans' cover of the window's idle time and each name's
    per-call time (ms), from a traced run's reader context."""
    from portbench import spans
    job = "compress" if "compress_source_bytes" in ctx.counters \
        else "extract"
    records = spans.port_records() or []
    root, function = spans.ROOTS[job]
    found = spans.offsets(records, ctx.trace, ctx.calls, job)
    pairing = {"calls": ctx.calls,
               "roots": sum(r.parent is None and r.name == root
                            for r in records),
               "functions": sum(spans.host_label(n)[0] == function
                                for n, _, _ in ctx.trace.host)}
    if found:
        xs = found[1]
        pairing.update(offset_quartiles_us=[
            x - statistics.median(xs) for x in statistics.quantiles(xs, n=4)],
            offset_min_max_us=[min(xs) - statistics.median(xs),
                               max(xs) - statistics.median(xs)])
    s = spans.load(ctx, job)
    if s is None:
        return {"spans": None, **pairing}
    gaps = ctx.trace.gaps()
    idle = sum(hi - lo for lo, hi in gaps)
    every = [s.interval(r) for r in s.records]
    stages = [s.interval(r) for r in s.records if r.parent is not None]
    names = sorted({r.name for r in s.records})
    per_call = {}
    for name in names:
        by_call = {}
        for r in s.records:
            if r.name == name:
                by_call[r.call] = by_call.get(r.call, 0.0) + sum(
                    hi - lo for lo, hi in s.own(r)) / 1e3
        per_call[name] = quartiles(list(by_call.values()))
    return {**pairing, "offset_spread_us": s.spread_us,
            "idle_s": idle / 1e6,
            "idle_under_any_span_pct": 100 * spans.overlap(gaps, every)
            / idle if idle else None,
            "idle_under_stages_pct": 100 * spans.overlap(gaps, stages)
            / idle if idle else None,
            "per_call_self_ms": per_call}


def run_report(args) -> int:
    import torch

    from portbench import run
    captured = {}
    reader = run.reader

    def capturing(name):
        read = reader(name)

        def wrapped(ctx):
            captured["ctx"] = ctx
            return read(ctx)
        return wrapped

    run.reader = capturing
    bench = run.load_json(ROOT / "BENCHMARK.json")
    line = run.run_cell(bench, args.workload, args.seed, args.seconds, True,
                        torch.device("cuda", 0))
    print(json.dumps(line), flush=True)
    out = {"workload": args.workload, "seed": args.seed,
           "card": card_line(), **report(captured["ctx"])}
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"line": line, "report": out}))
    return 0


def span_cost() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pycricodecs_tpu_torch.utils import tracing

    def loop(n=20_000) -> float:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with tracing.span("cost"):
                pass
        return (time.perf_counter_ns() - t0) / n

    off = statistics.median(loop() for _ in range(5))
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        on = statistics.median(loop() for _ in range(5))
    tracing.reset()
    return {"card": card_line(), "off_ns_per_span": off,
            "on_ns_per_span": on}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--out")
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)
    if args.cost:
        print(json.dumps(span_cost()), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA device", file=sys.stderr)
        return 2
    return run_report(args)


if __name__ == "__main__":
    sys.exit(main())
