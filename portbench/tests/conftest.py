"""The benchmark's own tests: `python3 -m pytest portbench/tests -q` from
the checkout root. Tests marked `card` need a CUDA device and skip
without one; on the card machine the same command runs them."""
import json
import sys
from pathlib import Path

import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def tiny_config(folder, codec: str = "adx", frames: int = 60,
                streams: int = 6) -> dict:
    """A bank small enough for the port's plain CPU compressor: the
    configuration's stream cut to its header, its first `frames` frames
    and (ADX) its end block, written into `folder`."""
    from portbench.run import load_json
    config = load_json(CHECKOUT / "portbench/configs" /
                       f"{codec}_bank_cpk.json")
    spec = dict(config["stream"])
    data = (CHECKOUT / spec["file"]).read_bytes()
    lo = spec["data_offset"]
    hi = lo + spec["frames"] * spec["frame_bytes"]
    cut = data[:lo + frames * spec["frame_bytes"]] + data[hi:]
    path = Path(folder) / f"tiny.{codec}"
    path.write_bytes(cut)
    spec.update(file=str(path), frames=frames)
    return dict(config, stream=spec, streams=streams)


@pytest.fixture()
def small(tmp_path):
    return tiny_config(tmp_path)


@pytest.fixture(scope="session")
def bench():
    from portbench.run import load_json
    return load_json(CHECKOUT / "BENCHMARK.json")


#: the extract cell that waits for a steadier host path (PERF.md §7), with
#: its end-to-end metric: its job stays tested, so that a later PR can add
#: the cell by entries alone
WAITING = {
    "workloads": [{"name": "adx_bank_cpk.extract", "config": "adx_bank_cpk",
                   "traffic": "extract", "chips": 1,
                   "why": "the ADX bank's 256 CRILAYLA blobs a call"}],
    "end_to_end": [{"name": "extract_mb_per_s", "unit": "MB/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock",
                    "workloads": ["adx_bank_cpk.extract"]}]}


def with_waiting(bench: dict) -> dict:
    """BENCHMARK.json with the waiting cell and its metric added."""
    out = json.loads(json.dumps(bench))
    for key, entries in WAITING.items():
        out[key] += entries
    return out


@pytest.fixture(scope="session")
def jobs_bench(bench):
    return with_waiting(bench)
