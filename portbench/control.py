"""The controls of the benchmark's comparison, run through a cell's own
run and judge at the cell's own size.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

runs the cell as `portbench.run` does (`run.run_cell`: its bank, set-up,
warm call, window and judge) with the program's entry replaced by the
plain reference with one guarantee of the configuration broken, the step
a faster program would be tempted by:

- compress cells: `crilayla.compress_members` replaced by
  `reference.compress_plain` with half the search window (candidates
  3 .. 0x1002 in place of 3 .. 0x2002);
- extract cells: `crilayla.decompress_batch` replaced by
  `reference.decompress_plain` with its copies' pointer jumping stopped
  after 2 rounds (the set-up still compresses with the port's C2).

Prints one JSON line a seed: the run's `correct` and the compared numbers
(`checks`). The window is one call (`--seconds 0`) unless asked. Run on
the card; it takes the first CUDA device (the CPU without one, at small
sizes only).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from portbench import reference, run
from portbench.run import CHECKOUT, load_json

CONTROL_WINDOW = reference.WINDOW // 2
CONTROL_ROUNDS = 2


def half_window(datas, *, device):
    return reference.compress_plain(list(datas), CONTROL_WINDOW, device)


def shallow_decoder(blobs, *, device):
    return reference.decompress_plain(list(blobs), CONTROL_ROUNDS, device)


#: the program's entry that each job's control replaces, and its stand-in
CONTROLS = {"compress": ("compress_members", half_window),
            "extract": ("decompress_batch", shallow_decoder)}


@contextlib.contextmanager
def in_place(job: str):
    """The program's entry of `job` replaced by its control."""
    from pycricodecs_tpu_torch.models import crilayla
    name, stand_in = CONTROLS[job]
    real = getattr(crilayla, name)
    setattr(crilayla, name, stand_in)
    try:
        yield
    finally:
        setattr(crilayla, name, real)


def control(workload: str, seed: int, device, bench: dict = None,
            config: dict = None, seconds: float = 0.0) -> dict:
    """The cell's result line with the control in the program's place."""
    bench = bench or load_json(CHECKOUT / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    traffic = load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    with in_place(traffic["job"]):
        return run.run_cell(bench, workload, seed, seconds, False, device,
                            config=config, t_start=time.perf_counter())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = control(args.workload, seed, device, seconds=args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": line["device"]["kind"],
                          "correct": line["correct"],
                          "checks": line["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
