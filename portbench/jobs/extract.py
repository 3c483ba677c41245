"""An extract of a compressed archive: set-up compresses the members once
with the port's C2 (`crilayla.compress_members`) and keeps, as
`CPKBuilder` does, a member's blob only where it is shorter than the
member; each call extracts the archive: its compressed members in groups
of at most `group_bytes` decompressed bytes (a larger member alone), one
`crilayla.decompress_batch` (kernel C1) a group, as `CPK.extract` bounds
its launches. Members stored raw are not decompressed, so no call has
them.

Judged: every member a sampled call returned, against the member's own
bytes, which the benchmark made."""
from __future__ import annotations

import numpy as np

HEADER = 16


class Job:
    def __init__(self, members: list, traffic: dict, device) -> None:
        from pycricodecs_tpu_torch.models import crilayla
        self.crilayla = crilayla
        self.device = device
        blobs = crilayla.compress_members(members, device=device)
        kept = [i for i, (m, b) in enumerate(zip(members, blobs))
                if b is not None and len(b) < len(m)]
        budget = int(traffic["group_bytes"])
        groups, i = [], 0
        while i < len(kept):
            j, held = i + 1, len(members[kept[i]])
            while j < len(kept) and held + len(members[kept[j]]) <= budget:
                held += len(members[kept[j]])
                j += 1
            groups.append(kept[i:j])
            i = j
        self.groups = [[blobs[k] for k in g] for g in groups]
        self.want = [members[k] for k in kept]
        self.members_per_call = len(kept)
        self.counts = {"extract_out_bytes": sum(len(members[k]) for k in kept),
                       "extract_in_bytes": sum(len(blobs[k]) - HEADER
                                               for k in kept)}

    def warm(self) -> None:
        self.run()

    def run(self) -> list:
        outs = []
        for blobs in self.groups:
            outs += self.crilayla.decompress_batch(blobs, device=self.device)
        return outs

    def count(self, outs: list) -> dict:
        return self.counts

    def judge(self, sample: list, rng: np.random.Generator) -> dict:
        wrong = 0
        for outs in sample:
            if len(outs) != len(self.want):
                wrong += len(self.want)
                continue
            wrong += sum(o != w for o, w in zip(outs, self.want))
        return {"members_wrong": (wrong, 0)}
