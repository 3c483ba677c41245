"""BENCHMARK.json against the contract's letter: names, units, files, the
cells each metric covers; and the result line's keys."""
import json
import re
import subprocess
import sys

import pytest

from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_texts(bench):
    names = []
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in bench["per_layer"]:
        assert TEXT.match(m["layer"])
    assert len(names) == len(set(names))
    for word in bench["command"]:
        assert TEXT.match(word)
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_name_has_its_file(bench):
    for c in bench["configs"]:
        assert (run.CHECKOUT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        traffic = run.load_json(run.HERE / "traffic" / f"{w['traffic']}.json")
        assert (run.HERE / "jobs" / f"{traffic['job']}.py").is_file()
        assert w["config"] in {c["name"] for c in bench["configs"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_every_cell_reports_setup_another_and_a_layer(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        def covers(m):
            return "workloads" not in m or w["name"] in m["workloads"]
        mine = [n for n, m in e2e.items() if covers(m)]
        assert "setup_s" in mine and len(mine) >= 2
        layers = [m for m in bench["per_layer"] if covers(m)]
        assert layers
        for m in layers:
            assert m["moves"] in mine
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_line_keys_and_checks_last(jobs_bench, small):
    line = run.run_cell(jobs_bench, "adx_bank_cpk.extract", 11, 0.2, False,
                        "cpu", config=small)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"extract_mb_per_s", "setup_s"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_cuda_means_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "adx_bank_cpk.compress", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=run.CHECKOUT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    import shutil
    shutil.copy(run.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-c",
                        "import sys; sys.path.insert(0, '.'); "
                        "from portbench import run, jobs; "
                        "import portbench.jobs.compress as c; "
                        "c.Job([b'x' * 600], {}, 'cpu')"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and "pycricodecs_tpu_torch" in p.stderr
