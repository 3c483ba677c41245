"""The `device` argument of the port's entry points.

The port's `device` is where its kernels run: a torch.device, or a string
such as "cuda", "cuda:1" or "cpu" (a CPU device runs each kernel's plain
version). The JAX package has parameters of the same name that are a bool,
its choice between its own engines; the port has one engine, so a bool
there is a call written for the JAX package, and it raises TypeError.
"""
from __future__ import annotations

import numpy as np
import torch


def as_device(device) -> torch.device:
    """`device` as a torch.device; TypeError for a bool (the JAX package's
    engine choice), which torch would otherwise refuse as "invalid
    types"."""
    if isinstance(device, (bool, np.bool_)):
        raise TypeError(
            f"device={device!r} is the JAX package's engine choice; the "
            "port's device is a torch device, such as 'cuda' or 'cpu'")
    return torch.device(device)
