"""The controls (control.py): the reference in the program's place, one
guarantee broken, through the cell's own run and judge, comes out as not
correct; at a size a test can hold here, and at the cell's own size on
the card."""
import pytest
import torch

from portbench import control, reference as R
from portbench.run import CHECKOUT, load_json


def deep_members():
    """Members whose greedy parse needs candidates past 0x1002 and whose
    copies chain deeper than 4 hops."""
    g = torch.Generator().manual_seed(5)

    def rand(n):
        return torch.randint(0, 256, (n,), generator=g,
                             dtype=torch.uint8).numpy().tobytes()
    block = rand(600)
    return [bytes(300) + block + rand(4400) + block, b"\x07" * 6000]


@pytest.mark.parametrize("cell,check", [
    ("adx_bank_cpk.compress", "blobs_wrong"),
    ("adx_bank_cpk.extract", "members_wrong")])
def test_control_fails_the_cells_judge(monkeypatch, jobs_bench, small,
                                       cell, check):
    from portbench import archive
    monkeypatch.setattr(archive, "make_members",
                        lambda c, s, d=None: deep_members())
    line = control.control(cell, 1, "cpu", jobs_bench, small)
    assert line["correct"] is False
    assert line["checks"][check]["value"] >= 1


def test_control_leaves_the_program_in_place(bench, small):
    from pycricodecs_tpu_torch.models import crilayla
    before = (crilayla.compress_members, crilayla.decompress_batch)
    control.control("adx_bank_cpk.compress", 1, "cpu", bench, small)
    assert (crilayla.compress_members, crilayla.decompress_batch) == before


def test_full_reference_passes_the_judges():
    datas = deep_members()
    blobs = R.compress_plain(datas)
    assert all(R.verify_compress(datas, blobs))
    assert R.decompress_plain(blobs) == datas


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in load_json(
    CHECKOUT / "BENCHMARK.json")["workloads"]])
def test_control_fails_the_cell_on_the_card(card, bench, cell):
    """At the cell's own configuration: one call, judged as a run is."""
    line = control.control(cell, 2**31 + 77, card, bench)
    assert line["correct"] is False, line["checks"]
