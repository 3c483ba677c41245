"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds pycricodecs_tpu_torch. Set-up
(counted in `setup_s` from this module's first line): imports, the
kernels' build or load, the bank made from its committed stream and the
seed (archive.py), the job's set-up and one warm call. The
window then runs the job's calls back to back, whole calls only, until
`--seconds` have passed, keeping a sample of calls drawn from the seed.
With `--trace 1` the window runs under torch.profiler (CPU and CUDA, with
Python stacks) and the per-layer metrics are read from its trace;
otherwise the end-to-end ones. After the window: the card's peak memory,
then the program's state freed, then the sampled calls judged against the
plain reference (reference.py). The last lines of standard error give each
compared number beside its limit, after one line of `info` (among it how
the window's calls' seconds spread, beside their page faults and CPU
time), and the last line of standard output is the result, its `checks`
last. Exits 2, printing no result, without a CUDA device, and 3 if jax,
jaxlib, flax or pycricodecs_tpu was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
#: top-level module names that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "pycricodecs_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reader(name: str):
    """The `read(ctx)` of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Reservoir:
    """A uniform sample of k of the window's calls, drawn from `rng` as
    they come (reservoir sampling), so that the calls it drops are freed."""

    def __init__(self, k: int, rng: np.random.Generator) -> None:
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def usage() -> tuple:
    """This process's (minor page faults, user CPU s, system CPU s) so
    far, all its threads."""
    u = resource.getrusage(resource.RUSAGE_SELF)
    return u.ru_minflt, u.ru_utime, u.ru_stime


def call_spread(call_s: list, used: list) -> dict:
    """How the window's calls spread: their wall seconds (median,
    quartiles), and for their minor page faults, user and system CPU
    seconds the median and the correlation with the wall seconds."""
    out = {"call_s_median": statistics.median(call_s)}
    if len(call_s) >= 4:
        out["call_s_quartiles"] = statistics.quantiles(call_s, n=4)
    for i, name in enumerate(("minflt", "user_s", "sys_s")):
        xs = [float(u[i]) for u in used]
        out[f"{name}_median"] = statistics.median(xs)
        if len(xs) >= 4 and len(set(xs)) > 1 and len(set(call_s)) > 1:
            out[f"{name}_r"] = statistics.correlation(call_s, xs)
    return out


class Context:
    """What a metric reader reads."""

    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)


def profiler(trace: bool):
    if not trace:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   with_stack=True)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, config: dict = None,
             t_start: float = T_START) -> dict:
    """One run of the cell `workload` on `device`: the result line as a
    dict. `config` replaces the configuration's file (small CPU tests)."""
    import torch
    from torch.profiler import record_function

    from portbench import archive

    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    if config is None:
        entry = next(c for c in bench["configs"]
                     if c["name"] == cell["config"])
        config = load_json(CHECKOUT / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    job_mod = importlib.import_module(f"portbench.jobs.{traffic['job']}")
    device = torch.device(device)
    cuda = device.type == "cuda"

    members = archive.make_members(config, seed, device)
    job = job_mod.Job(members, traffic, device)
    job.warm()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng(seed)
    sample = Reservoir(int(traffic["sample_calls"]), rng)
    counters, errors = {}, []
    calls = attempted = failed = 0
    call_s, used = [], []
    prof = profiler(trace)
    with prof:
        with record_function("portbench.window"):
            start = time.perf_counter()
            while True:
                n = job.members_per_call
                attempted += n
                t0, u0 = time.perf_counter(), usage()
                try:
                    outs = job.run()
                except Exception as exc:  # a failed call counts as failed
                    errors.append(f"{type(exc).__name__}: {exc}")
                    outs = None
                call_s.append(time.perf_counter() - t0)
                used.append([b - a for a, b in zip(u0, usage())])
                if outs is None:
                    failed += n
                else:
                    failed += max(0, n - len(outs)) + sum(
                        o is None for o in outs)
                    for k, v in job.count(outs).items():
                        counters[k] = counters.get(k, 0) + v
                    sample.offer(outs)
                calls += 1
                if time.perf_counter() - start >= seconds:
                    break
            window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    reduced = None
    if trace:
        from portbench.trace import Trace
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            reduced = Trace.load(path)
        finally:
            os.remove(path)
        del prof

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    judge_start = time.perf_counter()
    checks = job.judge(sample.items, rng)
    checks["members_failed"] = (failed, 0)
    judge_s = time.perf_counter() - judge_start

    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    peaks = load_json(HERE / "peaks.json")
    ctx = Context(setup_s=setup_s, window_s=window_s, calls=calls,
                  counters=counters, trace=reduced, peak=peaks.get(kind))
    metrics = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(peak)}
    line = {"correct": all(v <= lim for v, lim in checks.values()),
            "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": dev}
    if reduced is not None:
        dev.update(busy_s=reduced.busy_s, window_s=reduced.window_s)
        line["breakdown"] = {"device_ops": reduced.device_ops(),
                             "idle_gaps": reduced.idle_gaps()}
    line["info"] = {"calls": calls, "window_s": window_s, "judge_s": judge_s,
                    "sampled_calls": len(sample.items), "errors": errors[:5],
                    **call_spread(call_s, used)}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(CHECKOUT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = run_cell(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    print("portbench: " + json.dumps(line["info"]), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
