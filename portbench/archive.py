"""The members of one archive: a bank of real codec streams.

A configuration names one committed stream (`stream.file`, under
portbench/streams/) and how many members the bank holds (`streams`).
Each member is that stream with its frames turned round: the
`stream.frames` frames of `stream.frame_bytes` bytes that start at
`stream.data_offset` are rotated by a frame count drawn from the seed,
and the header before them and the end after them are kept. Every member
is then a stream of the same codec, of the same size, made of the same
frames, so every seed asks the same work of the program; no two members
are rotated alike, so a program cannot pass one member's result off as
another's.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parent.parent


def stream(config: dict) -> bytes:
    """The configuration's stream, as committed."""
    return (CHECKOUT / config["stream"]["file"]).read_bytes()


def rotations(config: dict, seed: int) -> list:
    """Each member's rotation in frames, drawn from the seed, no two
    alike (a bank has at most as many members as its stream has
    frames)."""
    rng = np.random.default_rng(seed)
    frames = int(config["stream"]["frames"])
    return [int(k) for k in rng.permutation(frames)[:int(config["streams"])]]


def make_members(config: dict, seed: int, device=None) -> list:
    """The bank's members as bytes, in bank order."""
    spec = config["stream"]
    data = stream(config)
    lo = int(spec["data_offset"])
    hi = lo + int(spec["frames"]) * int(spec["frame_bytes"])
    if hi > len(data):
        raise ValueError(f"{spec['file']}: {len(data)} bytes, the frames "
                         f"end at {hi}")
    head, body, tail = data[:lo], data[lo:hi], data[hi:]
    out = []
    for k in rotations(config, seed):
        cut = k * int(spec["frame_bytes"])
        out.append(head + body[cut:] + body[:cut] + tail)
    return out
