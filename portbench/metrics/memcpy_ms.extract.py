"""Device milliseconds a call of host-to-card and card-to-host copies
(Memcpy_HtoD + Memcpy_DtoH in the trace) (extract cells)."""


def read(ctx):
    if ctx.trace is None or "extract_out_bytes" not in ctx.counters:
        return None
    s = ctx.trace.device_seconds(
        lambda n: n in ("Memcpy_HtoD", "Memcpy_DtoH"))
    return s * 1e3 / ctx.calls if s else None
