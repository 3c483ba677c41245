"""The host layer's readers (spans.py and the metrics host_ms.compress,
host_idle_ms.compress, d2h_kept_pct.compress, host_bytes_per_byte.
compress): the records put on the reduced trace's clock, None where the
offsets spread past 50 us, where the calls differ or where the port has
no recorder; idle gaps intersected with the stages' self time; and, on
the port's card path run on the CPU with C2's plain version, each ratio
held exactly to the arithmetic of `crilayla_work_cap` and the blobs."""
import statistics
import sys
from collections import namedtuple

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import run, spans
from portbench.trace import WINDOW, Trace

METRICS = ("host_ms.compress", "host_idle_ms.compress",
           "d2h_kept_pct.compress", "host_bytes_per_byte.compress")
FUNC = "/x/pycricodecs_tpu_torch/models/crilayla.py(210): compress_members"
R = namedtuple("R", "name id parent call start_ns end_ns counts")
BASE_NS = 1_790_000_000_000_000_000  # the records' Unix ns at trace ts 0


def synthetic(offsets_us=(3.0, 3.0), busy=((150.0, 450.0),)):
    """A reduced trace of a call a ms (at ts 0, 1000, ... us), each opened by
    compress_members (ending at 990 us) and holding a pack (0-100 us
    after the root), a d2h (500-600) and a collect (700-900) span, the
    root (990 us long) starting and ending offsets_us after the function;
    device busy over `busy` (us). Returns (trace, records)."""
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW,
               "ts": 0.0, "dur": 1000.0 * len(offsets_us)}]
    records, rid = [], 0
    for k, t in enumerate(1000.0 * k for k in range(len(offsets_us))):
        events.append({"ph": "X", "cat": "python_function", "name": FUNC,
                       "ts": t, "dur": 990.0})
        root0 = BASE_NS + int((t + offsets_us[k]) * 1e3)
        rid += 3
        records += [
            R("crilayla.pack", rid + 1, rid, rid, root0, root0 + 100_000,
              {"host_bytes": 200}),
            R("crilayla.collect", rid + 2, rid, rid, root0 + 700_000,
              root0 + 900_000, {"host_bytes": 50}),
            R("crilayla.d2h", rid + 3, rid, rid, root0 + 500_000,
              root0 + 600_000, {"d2h_bytes": 150, "d2h_kept_bytes": 60}),
            R("crilayla.compress", rid, None, rid, root0, root0 + 990_000,
              {"members": 2, "source_bytes": 100})]
        rid += 3
    for lo, hi in busy:
        events.append({"ph": "X", "cat": "kernel", "name": "c2_search",
                       "ts": lo, "dur": hi - lo})
    return Trace(events), records


def test_records_land_on_the_traces_clock():
    """Roots 3 and 5 us after their functions: the offset is the median
    (4 us), so each root lands within 1 us of its function, and its
    stages keep their places in it."""
    trace, records = synthetic((3.0, 5.0))
    s = spans.from_records(records, trace, 2)
    assert s.spread_us == spans.spread([0.0, 2.0])
    roots = sorted((r for r in records if r.parent is None),
                   key=lambda r: r.start_ns)
    assert [s.interval(r)[0] for r in roots] == pytest.approx([-1.0, 1001.0])
    pack = s.self_intervals({"crilayla.pack"})
    assert pack == pytest.approx([(-1.0, 99.0), (1001.0, 1101.0)])


@pytest.mark.parametrize("offsets,calls,ok", [
    ((3.0,) * 7 + (503.0,), 8, True),   # one call far off: quartiles hold
    (tuple(10.0 * k for k in range(8)), 8, True),   # spread 45 us
    (tuple(12.0 * k for k in range(8)), 8, False),  # spread 54 us
    ((3.0, 3.0), 3, False),
    ((3.0, 3.0), 1, False)])
def test_offsets_spread_and_calls(offsets, calls, ok):
    trace, records = synthetic(offsets)
    s = spans.from_records(records, trace, calls)
    assert (s is not None) == ok
    if ok:  # on the first root's clock, the median call's offset
        assert s.offset_us == pytest.approx(statistics.median(offsets)
                                            - offsets[0])


def test_spread_is_the_interquartile_distance():
    assert spans.spread([]) == spans.spread([7.0]) == 0
    xs = [10.0 * k for k in range(8)]
    assert spans.spread(xs) == pytest.approx(45.0)


def test_idle_under_the_stages_and_self_time(monkeypatch):
    trace, records = synthetic(busy=((50.0, 80.0), (750.0, 800.0)))
    monkeypatch.setattr(spans, "port_records", lambda: records)
    s = spans.from_records(records, trace, 2)
    stages = spans.HOST_STAGES

    def self_us(names):
        return sum(hi - lo for lo, hi in s.self_intervals(names))

    # the root's self time is its span less pack, d2h and collect
    assert self_us({"crilayla.compress"}) == pytest.approx(
        2 * (990 - 100 - 100 - 200))
    assert self_us(stages) == pytest.approx(2 * 300)
    busy_under = (80 - 50) + (800 - 750)  # in the first call's stages
    idle = spans.overlap(trace.gaps(), s.self_intervals(stages))
    assert idle == pytest.approx(2 * 300 - busy_under)
    ctx = run.Context(trace=trace, calls=2)
    got = {m: run.reader(m)(ctx) for m in METRICS}
    assert got["host_ms.compress"] == pytest.approx(0.3)
    assert got["host_idle_ms.compress"] == pytest.approx(
        (600 - busy_under) / 1e3 / 2)


def test_overlap_and_merged():
    assert spans.merged([(5, 7), (1, 3), (2, 4), (6, 6)]) == [(1, 4), (5, 7)]
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap([(0, 10)], [(2, 3), (2, 4), (8, 12)]) == 4
    assert spans.overlap([], [(0, 1)]) == 0


def test_without_the_recorder_no_metric(monkeypatch):
    trace, _ = synthetic()
    monkeypatch.setitem(sys.modules, "pycricodecs_tpu_torch.utils.tracing",
                        None)
    assert spans.port_records() is None
    ctx = run.Context(trace=trace, calls=2)
    assert all(run.reader(m)(ctx) is None for m in METRICS)
    assert all(run.reader(m)(run.Context(trace=None, calls=2)) is None
               for m in METRICS)


def test_a_cpu_run_reports_none_of_them(bench, small):
    """The plain versions record their root span only: a traced CPU run
    reads no host-layer metric (and no device number)."""
    from pycricodecs_tpu_torch.utils import tracing
    tracing.reset()
    line = run.run_cell(bench, "adx_bank_cpk.compress", 2**31 + 7, 0.2,
                        True, "cpu", config=small)
    tracing.reset()
    assert line["correct"] is True
    assert not set(METRICS) & set(line["metrics"])


def test_ratios_on_a_small_bank(monkeypatch, tmp_path, small):
    """The port's card path (C2 replaced by its plain version) in a
    traced window of three calls: the readers give the counts' exact
    ratios, and with no device work every host stage is idle."""
    from portbench import archive
    from pycricodecs_tpu_torch.models import crilayla
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.utils import tracing
    from tests.test_torch_tracing import fake_card
    data = archive.make_members(small, 5)
    fake_card(monkeypatch, data * 3)
    monkeypatch.setattr(crilayla, "C2_BUDGET", 2 * len(data[0]))
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU], with_stack=True) as p:
        with record_function(WINDOW):
            blobs = [crilayla.compress_members(data, device="meta")
                     for _ in range(3)]
    path = tmp_path / "t.json"
    p.export_chrome_trace(str(path))
    ctx = run.Context(trace=Trace.load(str(path)), calls=3)
    got = {m: run.reader(m)(ctx) for m in METRICS}
    tracing.reset()
    assert blobs[0] == crilayla.compress_members(data, device="cpu")
    lengths = np.array([len(d) for d in data])
    caps = cuda_kernels.crilayla_work_cap(lengths)
    streams = sum(len(b) - 16 - 0x100 for b in blobs[0])
    assert got["d2h_kept_pct.compress"] == pytest.approx(
        100 * streams / (caps.sum() + 12 * len(data)), rel=1e-12)
    assert got["host_bytes_per_byte.compress"] == pytest.approx(
        (2 * lengths.sum() + 3 * streams
         + crilayla.ASSEMBLE_BYTES * len(data)) / lengths.sum(), rel=1e-12)
    assert got["host_ms.compress"] > 0
    assert got["host_idle_ms.compress"] == pytest.approx(
        got["host_ms.compress"], rel=1e-6)


@pytest.mark.card
@pytest.mark.parametrize("codec", ["adx", "hca"])
def test_a_traced_run_on_the_card_reports_the_host_metrics(
        card, bench, tmp_path, monkeypatch, codec):
    """A short traced run of a small bank: the four metrics are read, the
    host stages' idle time within their self time, the kept share
    below 100 %."""
    from portbench.tests.conftest import tiny_config
    cell = f"{codec}_bank_cpk.compress"
    seen = {}
    reader = run.reader

    def capturing(name):
        def read(ctx):
            seen["ctx"] = ctx
            return reader(name)(ctx)
        return read

    monkeypatch.setattr(run, "reader", capturing)
    from pycricodecs_tpu_torch.utils import tracing
    tracing.reset()  # a run is a process of its own: no earlier records
    line = run.run_cell(bench, cell, 2**31 + 99, 2.0, True, card,
                        config=tiny_config(tmp_path, codec, 200, 8))
    assert line["correct"] is True
    ctx = seen["ctx"]
    found = spans.offsets(spans.port_records(), ctx.trace, ctx.calls)
    assert found is not None, (ctx.calls, len(spans.port_records()))
    assert spans.spread(found[1]) <= spans.MAX_SPREAD_US, found[1]
    got = {m: line["metrics"][m]["value"] for m in METRICS}
    assert 0 < got["host_idle_ms.compress"] <= got["host_ms.compress"] * 1.01
    assert 0 < got["d2h_kept_pct.compress"] < 100
    assert got["host_bytes_per_byte.compress"] > 2
