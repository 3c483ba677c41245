"""A run with the timed path broken underneath comes out not correct:
an answer altered where it is produced, half of the batch left out, and
the input handed back unchanged. The harness runs on the CPU here (the
port's plain versions), without its look for a card."""
import pytest

from portbench import run


def broken(fault):
    def wrap(fn):
        def call(items, *, device):
            outs = list(fn(items, device=device))
            if fault == "altered":
                b = bytearray(outs[len(outs) // 2])
                b[len(b) // 2] ^= 0x01
                outs[len(outs) // 2] = bytes(b)
            elif fault == "half":
                outs = outs[:len(outs) // 2]
            elif fault == "unchanged":
                outs = [bytes(i) for i in items]
            return outs
        return call
    return wrap


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
@pytest.mark.parametrize("cell,entry", [
    ("adx_bank_cpk.compress", "compress_members"),
    ("adx_bank_cpk.extract", "decompress_batch")])
def test_fault_is_not_correct(monkeypatch, jobs_bench, small, cell, entry,
                             fault):
    from pycricodecs_tpu_torch.models import crilayla
    real = getattr(crilayla, entry)
    if entry == "decompress_batch":
        # set-up compresses with the real C2 path; the window's C1 breaks
        monkeypatch.setattr(crilayla, entry, broken(fault)(real))
    else:
        calls = {"n": 0}

        def compress(items, *, device):
            calls["n"] += 1
            return broken(fault)(real)(items, device=device)
        monkeypatch.setattr(crilayla, entry, compress)
    line = run.run_cell(jobs_bench, cell, 21, 0.2, False, "cpu",
                        config=small)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ["adx_bank_cpk.compress",
                                  "adx_bank_cpk.extract",
                                  "hca_bank_cpk.compress"])
def test_sound_run_is_correct(jobs_bench, small, cell):
    line = run.run_cell(jobs_bench, cell, 21, 0.2, False, "cpu", config=small)
    assert line["correct"] is True, line["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["adx_bank_cpk.compress",
                                  "adx_bank_cpk.extract"])
def test_sound_run_on_the_card(card, jobs_bench, tmp_path, cell):
    from portbench.tests.conftest import tiny_config
    small = tiny_config(tmp_path, frames=4000, streams=32)
    line = run.run_cell(jobs_bench, cell, 2**31 + 5, 1.0, True, card,
                        config=small)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["busy_s"] > 0
