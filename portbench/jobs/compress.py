"""A repack with compression on: each call hands the whole archive to
`crilayla.compress_members`, the call `CPKBuilder(compress=True)` makes
(one launch of C2 for each run of members within `C2_BUDGET`, a larger
member alone), and gets every member's CRILAYLA blob back.

Judged: every member's blob in one sampled call against the plain
reference (`reference.verify_compress`: the greedy parse the
configuration's guarantee names, byte for byte); every other sampled
call's blobs against that call's, which the same inputs make equal."""
from __future__ import annotations

import numpy as np

from portbench import reference

BLOB_OVERHEAD = 16 + 0x100  # header and raw prefix around a stream


class Job:
    def __init__(self, members: list, traffic: dict, device) -> None:
        from pycricodecs_tpu_torch.models import crilayla
        self.crilayla = crilayla
        self.members = members
        self.device = device
        self.source_bytes = sum(len(m) for m in members)
        self.members_per_call = len(members)

    def warm(self) -> None:
        self.run()

    def run(self) -> list:
        return self.crilayla.compress_members(self.members,
                                              device=self.device)

    def count(self, outs: list) -> dict:
        return {"compress_source_bytes": self.source_bytes,
                "compress_stream_bytes": sum(len(b) - BLOB_OVERHEAD
                                             for b in outs if b)}

    def judge(self, sample: list, rng: np.random.Generator) -> dict:
        wrong = set()
        if sample:
            first = int(rng.integers(len(sample)))
            judged = sample[first]
            ok = reference.verify_compress(self.members, judged,
                                           device=self.device)
            wrong.update(i for i, good in enumerate(ok) if not good)
            for k, outs in enumerate(sample):
                if k != first:
                    wrong.update(i for i in range(len(self.members))
                                 if i >= len(outs) or outs[i] != judged[i])
        return {"blobs_wrong": (len(wrong), 0)}
