"""PyTorch port, the recorder of spans and counts (pycricodecs_tpu_torch/
utils/tracing.py) and its spans on the CRILAYLA path: nothing recorded and
no `record_function` entered without a profiler; names, parents, calls
and counts under one; each span in the Chrome trace on the record's clock;
self time; the cap; `parallel.trace`'s `spans`; one root span a call of
`compress_members`, `decompress_batch` and a CPK extract's batch on the
CPU; the card paths' stages and byte counts on the CPU, with C2 and C1
replaced by their plain versions. Tests marked `card` run the kernels'
path and skip without a CUDA device: every stage's span once a wrapper
call, the copies' byte counts, and the stages' cover of a call's
device-idle time."""
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pycricodecs_tpu_torch import parallel as port_parallel
from pycricodecs_tpu_torch.containers import cpk as port_cpk
from pycricodecs_tpu_torch.models import crilayla
from pycricodecs_tpu_torch.ops import cuda_kernels
from pycricodecs_tpu_torch.utils import tracing

COMPRESS_STAGES = ("crilayla.pack", "crilayla.h2d", "c2.prepare",
                   "c2.launch", "crilayla.wait", "crilayla.d2h",
                   "crilayla.collect")
EXTRACT_STAGES = ("crilayla.parse", "crilayla.pack", "crilayla.h2d",
                  "c1.prepare", "c1.launch", "crilayla.wait", "crilayla.d2h",
                  "crilayla.collect")


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


def members(n=3, size=3000, seed=1) -> list:
    """Small compressible members: random runs repeated."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        unit = rng.integers(0, 256, 97, dtype=np.uint8).tobytes()
        out.append((unit * (size // 97 + 1))[:size])
    return out


def by_name(recs) -> dict:
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_no_profiler_records_nothing_and_enters_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("entered with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing.time, "time_ns", refuse)
    assert not tracing.enabled()
    blobs = crilayla.compress_members(members(), device="cpu")
    assert crilayla.decompress_batch(blobs, device="cpu") == members()
    with tracing.span("x", a=1) as s:
        tracing.count("a", 2)
    assert s is tracing.span("y")  # one shared no-op, nothing made
    tracing.count("b", 1)
    assert tracing.records() == [] and tracing.dropped() == 0


def test_records_carry_names_parents_calls_and_counts():
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.enabled()
        with tracing.span("outer", k=1):
            with tracing.span("inner"):
                tracing.count("n", 3)
                tracing.count("n", 4)
            tracing.count("k", 2)
        with tracing.span("second"):
            pass
        tracing.count("lost", 1)  # no open span: dropped silently
    recs = by_name(tracing.records())
    outer, inner, second = (recs[k][0] for k in ("outer", "inner",
                                                 "second"))
    assert outer.parent is None and outer.call == outer.id
    assert inner.parent == outer.id and inner.call == outer.id
    assert second.parent is None and second.call == second.id != outer.id
    assert outer.counts == {"k": 3} and inner.counts == {"n": 7}
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns
    assert [r.name for r in tracing.records()] == ["inner", "outer",
                                                   "second"]


def test_threads_keep_their_own_parents(monkeypatch):
    """Spans of many threads at once (the recorder on, as a profiler
    that traced every thread would have it): each thread's spans nest
    under its own, every id is unique and no record is lost."""
    import contextlib
    import sys
    monkeypatch.setattr(tracing, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: contextlib.nullcontext())
    n_threads, n_spans = 16, 200

    def worker(k):
        for _ in range(n_spans):
            with tracing.span(f"t{k}"):
                with tracing.span(f"t{k}.child"):
                    tracing.count("n", 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    recs = tracing.records()
    assert len(recs) == 2 * n_threads * n_spans
    assert len({r.id for r in recs}) == len(recs)
    ids = {r.id: r for r in recs}
    for r in recs:
        if r.name.endswith(".child"):
            root = ids[r.parent]
            assert root.name == r.name[:-len(".child")]
            assert r.call == root.id and r.counts == {"n": 1}
        else:
            assert r.parent is None and r.call == r.id


def test_spans_sit_in_the_chrome_trace_on_the_records_clock(tmp_path):
    """Each record's start is within 50 us of its user_annotation's `ts`
    + `baseTimeNanoseconds` / 1000: the same clock. One round of three
    must hold for every span (a round on a loaded host can be preempted
    between the two stamps; a wrong clock is off in every round)."""
    names = [f"clock.{i}" for i in range(5)]
    worst = []
    for attempt in range(3):
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tracing.span("clock.warm"):
                pass
            for name in names:
                with tracing.span(name):
                    sum(range(1000))
        path = tmp_path / f"t{attempt}.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
        base_us = trace["baseTimeNanoseconds"] / 1e3
        marks = {e["name"]: e["ts"] + base_us for e in trace["traceEvents"]
                 if e.get("cat") == "user_annotation"}
        recs = by_name(tracing.records())
        assert set(names) <= set(marks)
        worst.append(max(abs(marks[n] - recs[n][0].start_ns / 1e3)
                         for n in names))
        if worst[-1] <= 50:
            break
    assert min(worst) <= 50, worst


def test_self_time_is_the_span_less_its_children():
    R = tracing.Record
    recs = [R("a", 1, None, 1, 0, 1000, {"x": 1}),
            R("b", 2, 1, 1, 100, 300, {"x": 2}),
            R("c", 3, 1, 1, 500, 900, {}),
            R("d", 4, 3, 1, 600, 700, {}),
            R("b", 5, None, 5, 2000, 2100, {"x": 4})]
    own = tracing.self_ns(recs)
    assert own == {1: 400, 2: 200, 3: 300, 4: 100, 5: 100}
    s = tracing.summary(recs)["by_name"]
    assert s["b"]["count"] == 2 and s["b"]["counts"] == {"x": 6}
    assert s["a"]["total_s"] == pytest.approx(1e-6)
    assert s["a"]["self_s"] == pytest.approx(4e-7)
    assert s["b"]["self_s"] == pytest.approx(3e-7)


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    assert [r.name for r in tracing.records()] == ["s0", "s1", "s2"]
    assert tracing.dropped() == 2
    tracing.reset()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_parallel_trace_returns_the_spans(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("before"):  # cleared when the trace starts
            pass
    with port_parallel.trace(str(tmp_path / "prof")) as tr:
        blobs = crilayla.compress_members(members(), device="cpu")
    assert tr.path is not None and tr.spans is not None
    names = [r.name for r in tr.spans["records"]]
    assert names == ["crilayla.compress"]
    root = tr.spans["by_name"]["crilayla.compress"]
    assert root["count"] == 1 and root["self_s"] == root["total_s"] > 0
    assert root["counts"] == {"members": 3, "source_bytes": 9000}
    assert tr.spans["dropped"] == 0
    with port_parallel.trace(str(tmp_path / "prof")) as tr:
        crilayla.decompress_batch(blobs, device="cpu")
    assert set(tr.spans["by_name"]) == {"crilayla.decompress",
                                        "crilayla.parse"}


def test_cpu_calls_make_one_root_span_each():
    data = members(4)
    with profile(activities=[ProfilerActivity.CPU]):
        blobs = crilayla.compress_members(data, device="cpu")
        outs = crilayla.decompress_batch(blobs, device="cpu")
    assert outs == data
    recs = tracing.records()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["crilayla.compress",
                                       "crilayla.decompress"]
    assert roots[0].counts == {"members": 4, "source_bytes": 12000}
    (parse,) = [r for r in recs if r.parent is not None]
    assert parse.name == "crilayla.parse" and parse.call == roots[1].id
    # the payload slices: each blob less its 16-byte header
    assert parse.counts == {"host_bytes": sum(len(b) - 16 for b in blobs)}


def test_cpk_extract_makes_a_root_span_a_batch(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for i, m in enumerate(members(3)):
        (src / f"m{i}.bin").write_bytes(m)
    path = tmp_path / "t.cpk"
    port_cpk.CPKBuilder(str(src), str(path), CpkMode=1, compress=True,
                        device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        port_cpk.CPK(str(path), device="cpu").extract(str(tmp_path / "out"))
    names = by_name(tracing.records())
    (root,) = names["crilayla.decompress"]
    (parse,) = names["crilayla.parse"]
    assert root.parent is None and parse.parent == root.id
    for i, m in enumerate(members(3)):
        assert (tmp_path / "out" / f"m{i}.bin").read_bytes() == m


def fake_card(monkeypatch, datas) -> None:
    """`compress_members`' card path on the CPU: a "meta" device takes it
    past the CPU branch (its H2D makes no data), C2 is replaced by the
    plain compressor placing each stream where C2 does (the end of its
    member's work buffer; the members taken in call order from `datas`),
    and the wait is a no-op."""
    todo = iter(datas)

    def c2(src, meta, work_size):
        work = np.zeros(work_size, np.uint8)
        start = np.zeros(len(meta), np.int64)
        status = np.zeros(len(meta), np.int32)
        for m, (_, n, w) in enumerate(meta):
            data = next(todo)
            assert len(data) == n
            if n < 0x101:
                status[m] = 1
                continue
            stream = crilayla._compress_py(data)[16:-0x100]
            cap = int(cuda_kernels.crilayla_work_cap(n))
            start[m] = cap - len(stream)
            work[w + start[m]:w + cap] = np.frombuffer(stream, np.uint8)
        return (torch.from_numpy(work), torch.from_numpy(start),
                torch.from_numpy(status), torch.zeros(len(meta)))

    class Stream:
        def synchronize(self):
            pass

    monkeypatch.setattr(cuda_kernels, "crilayla_compress", c2)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())


def test_the_card_paths_spans_and_counts_on_the_cpu(monkeypatch):
    data = members(5, 4000) + [b"too small"]
    fake_card(monkeypatch, data * 2)
    monkeypatch.setattr(crilayla, "C2_BUDGET", 3 * 4000)
    want = crilayla.compress_members(data, device="cpu")
    assert crilayla.compress_members(data, device="meta") == want
    assert tracing.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert crilayla.compress_members(data, device="meta") == want
    names = by_name(tracing.records())
    (root,) = names["crilayla.compress"]
    assert root.counts == {"members": 6, "source_bytes": 20009}
    for stage in ("crilayla.pack", "crilayla.h2d", "crilayla.wait",
                  "crilayla.d2h", "crilayla.collect"):
        assert len(names[stage]) == 2, stage  # two wrapper calls
        assert all(r.parent == root.id for r in names[stage])
    total = lambda name, key: sum(r.counts.get(key, 0)  # noqa: E731
                                  for r in names[name])
    lengths = np.array([len(d) for d in data])
    streams = sum(len(b) - 16 - 0x100 for b in want if b)
    assert total("crilayla.h2d", "h2d_bytes") == lengths.sum()
    assert total("crilayla.pack", "host_bytes") == 2 * lengths.sum()
    assert total("crilayla.d2h", "d2h_bytes") == (
        cuda_kernels.crilayla_work_cap(lengths).sum() + 12 * 6)
    assert total("crilayla.d2h", "d2h_kept_bytes") == streams
    assert total("crilayla.collect", "host_bytes") == (
        3 * streams + crilayla.ASSEMBLE_BYTES * 5)


def test_the_extract_card_paths_spans_and_counts_on_the_cpu(monkeypatch):
    """`decompress_batch`'s card path on the CPU, as `fake_card` does it
    for C2: C1 replaced by the plain decompressor, each member placed at
    its output offset."""
    data = members(4, 5000)
    blobs = crilayla.compress_members(data, device="cpu")
    parsed = iter([crilayla.parse(b) for b in blobs])

    def c1(src, meta, out_size):
        out = np.zeros(out_size, np.uint8)
        for m in range(len(meta)):
            got = crilayla._decompress_py(*next(parsed))
            out[meta[m, 3]:meta[m, 3] + len(got)] = np.frombuffer(got,
                                                                   np.uint8)
        status = torch.zeros(len(meta), dtype=torch.int32)
        return torch.from_numpy(out), status, torch.zeros(len(meta))

    class Stream:
        def synchronize(self):
            pass

    monkeypatch.setattr(cuda_kernels, "crilayla_decompress", c1)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    with profile(activities=[ProfilerActivity.CPU]):
        assert crilayla.decompress_batch(blobs, device="meta") == data
    names = by_name(tracing.records())
    (root,) = names["crilayla.decompress"]
    for stage in ("crilayla.parse", "crilayla.pack", "crilayla.h2d",
                  "crilayla.wait", "crilayla.d2h", "crilayla.collect"):
        (r,) = names[stage]
        assert r.parent == root.id, stage
    payloads = sum(len(b) - 16 for b in blobs)
    assert names["crilayla.parse"][0].counts == {"host_bytes": payloads}
    assert names["crilayla.pack"][0].counts == {"host_bytes": payloads}
    assert names["crilayla.h2d"][0].counts == {"h2d_bytes": payloads}
    assert names["crilayla.d2h"][0].counts == {
        "d2h_bytes": 20000 + 4 * 4, "d2h_kept_bytes": 20000}
    assert names["crilayla.collect"][0].counts == {"host_bytes": 20000}


# -- on the card -----------------------------------------------------------

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def device_intervals(trace: dict) -> list:
    """[(lo, hi)] in Unix us of the trace's kernels, copies and fills."""
    base = trace["baseTimeNanoseconds"] / 1e3
    return sorted((e["ts"] + base, e["ts"] + base + e["dur"])
                  for e in trace["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy",
                                       "gpu_memset"))


def gaps_in(lo: float, hi: float, busy: list) -> list:
    """[(a, b)] of [lo, hi] that no interval of `busy` (sorted) covers."""
    out, end = [], lo
    for a, b in busy:
        a, b = max(a, lo), min(b, hi)
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return out


def covered(gaps: list, spans: list) -> float:
    total = 0.0
    for a, b in gaps:
        for lo, hi in spans:
            total += max(0.0, min(b, hi) - max(a, lo))
    return total


@pytest.mark.card
def test_every_compress_stage_once_a_wrapper_call(card, monkeypatch):
    data = members(6, 200_000)
    crilayla.compress_members(data, device=card)  # build and warm
    monkeypatch.setattr(crilayla, "C2_BUDGET", 3 * 200_000)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        blobs = crilayla.compress_members(data, device=card)
    assert blobs == crilayla.compress_members(data, device=card)
    names = by_name(tracing.records())
    (root,) = names["crilayla.compress"]
    for stage in COMPRESS_STAGES:
        assert len(names[stage]) == 2, stage  # two wrapper calls
        assert all(r.call == root.id for r in names[stage])
    caps = cuda_kernels.crilayla_work_cap(np.array([len(d) for d in data]))
    total = lambda name, key: sum(r.counts.get(key, 0)  # noqa: E731
                                  for r in names[name])
    assert total("crilayla.h2d", "h2d_bytes") == sum(map(len, data))
    assert total("crilayla.d2h", "d2h_bytes") == int(caps.sum()) + 12 * 6
    streams = sum(len(b) - 16 - 0x100 for b in blobs)
    assert total("crilayla.d2h", "d2h_kept_bytes") == streams
    assert total("crilayla.pack", "host_bytes") == 2 * sum(map(len, data))
    assert total("crilayla.collect", "host_bytes") == (
        3 * streams + crilayla.ASSEMBLE_BYTES * 6)
    assert root.counts == {"members": 6, "source_bytes": 1_200_000}


@pytest.mark.card
def test_every_extract_stage_once_a_call(card):
    data = members(4, 100_000)
    blobs = crilayla.compress_members(data, device=card)
    crilayla.decompress_batch(blobs, device=card)  # build and warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        outs = crilayla.decompress_batch(blobs, device=card)
    assert outs == data
    names = by_name(tracing.records())
    (root,) = names["crilayla.decompress"]
    for stage in EXTRACT_STAGES:
        assert len(names[stage]) == 1, stage
        assert names[stage][0].call == root.id
    (h2d,), (d2h,) = names["crilayla.h2d"], names["crilayla.d2h"]
    assert h2d.counts["h2d_bytes"] == sum(len(b) - 16 for b in blobs)
    assert d2h.counts["d2h_bytes"] == sum(map(len, data)) + 4 * 4
    assert d2h.counts["d2h_kept_bytes"] == sum(map(len, data))


@pytest.mark.card
def test_stages_cover_a_calls_device_idle_time(card, tmp_path):
    """Of the device-idle time inside a traced compress call, at least
    95 % lies under one of its stages' spans (the root's own time, the
    gaps between stages, is the rest)."""
    data = members(32, 1 << 20, seed=7)
    crilayla.compress_members(data, device=card)  # build and warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        crilayla.compress_members(data, device=card)
    path = tmp_path / "c.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    recs = tracing.records()
    (root,) = [r for r in recs if r.parent is None]
    idle = gaps_in(root.start_ns / 1e3, root.end_ns / 1e3,
                   device_intervals(trace))
    stages = [(r.start_ns / 1e3, r.end_ns / 1e3) for r in recs
              if r.parent == root.id]
    total = sum(b - a for a, b in idle)
    assert total > 0
    assert covered(idle, stages) >= 0.95 * total
