"""A device grid for the sharded entry points (the port's counterpart of
the JAX package's `make_mesh` and `jax.sharding.Mesh`).

The JAX package is single-controller: one process drives every device of
its mesh, and each sharded entry point returns the whole batch's output.
The port keeps that contract with one process and a grid of
`torch.device`s: an entry point enqueues each shard's work on its own
device (CUDA launches are asynchronous per device, so shards on different
cards overlap) and fetches every shard's output only after the last one
is launched. There is no process group.

The first axis ("dp") shards streams, the second ("sp") frames where a
path splits them. A grid may list one device several times: the tests run
meshes of `["cpu"] * 8`, the counterpart of the JAX tests' eight virtual
CPU devices, and `chip_smoke.py` meshes of `["cuda:0"] * 4`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import as_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """devices: object ndarray of torch.device, shaped like the mesh;
    axis_names: one name an axis; shape: devices.shape."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def dp(self) -> int:
        """Shards of the stream axis."""
        return self.shape[0]

    @property
    def sp(self) -> int:
        """Shards of the frame axis (1 for a one-axis mesh)."""
        return self.shape[1] if len(self.shape) > 1 else 1

    def stream_devices(self) -> list:
        """One device a stream shard: the first of each row of the grid
        (the streams replicate over sp, as a JAX spec (dp,) places them)."""
        return list(self.devices.reshape(self.dp, -1)[:, 0])

    def flat_devices(self) -> list:
        """Every device of the grid, row-major."""
        return list(self.devices.reshape(-1))


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp", "sp"), *,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a device mesh. devices: the grid's devices in row-major order
    (each a torch.device or a string such as "cuda:1" or "cpu"; one may
    repeat), by default every visible CUDA device; shape: by default all of
    them on "dp", (n, 1). Like the JAX function it takes the first
    prod(shape) devices. Raises where CUDA is absent and no devices are
    given, and where the shape needs more devices than there are."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices= (e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [as_device(d) for d in devices]
    for d in devs:
        if d.type == "cuda" and d.index is None:
            raise ValueError("make_mesh: give CUDA devices with an index "
                             "(cuda:0), not the current device")
    if shape is None:
        shape = (len(devs), 1)
    shape = tuple(int(n) for n in shape)
    if not shape or min(shape) < 1:
        raise ValueError(f"make_mesh: bad shape {shape}")
    if len(shape) > 2:
        raise ValueError(f"make_mesh: at most two axes (dp, sp), got "
                         f"{shape}")
    names = tuple(axis_names)[:len(shape)]
    if len(names) != len(shape):
        raise ValueError(f"make_mesh: {len(shape)} axes need as many names, "
                         f"got {tuple(axis_names)}")
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"make_mesh: shape {shape} needs {n} devices, "
                         f"{len(devs)} given")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(shape), names)


def shard_rows(a: np.ndarray, n: int) -> list:
    """The rows of `a` as n equal contiguous shards, zero rows added at the
    end to make them so (a padded stream is silence, or zero frames, that
    the caller drops)."""
    rows = max(1, -(-a.shape[0] // n))
    shards = []
    for i in range(n):
        part = a[i * rows:(i + 1) * rows]
        if part.shape[0] < rows:
            part = np.concatenate([part, np.zeros(
                (rows - part.shape[0],) + a.shape[1:], a.dtype)])
        shards.append(np.ascontiguousarray(part))
    return shards


def check_mesh(mesh) -> Mesh:
    """`mesh` itself, or TypeError where it is not a Mesh."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh: expected a parallel.Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh
