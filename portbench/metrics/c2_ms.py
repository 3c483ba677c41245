"""Device milliseconds a call of kernel C2's kernels (csrc/crilayla.cu:
summary, carry, search, spec, repair, count, offsets, place; by name,
`c2_*`)."""


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.device_seconds(lambda n: n.startswith("c2_"))
    return s * 1e3 / ctx.calls if s else None
