"""Device milliseconds a call of kernel C1's kernels (csrc/crilayla.cu:
spec, repair, count, offsets, place, finish, resolve, jump, gather; by
name, `c1_*`)."""


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.device_seconds(lambda n: n.startswith("c1_"))
    return s * 1e3 / ctx.calls if s else None
