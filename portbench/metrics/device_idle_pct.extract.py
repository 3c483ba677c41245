"""Share of the traced window, in %, in which no kernel, copy or fill
ran on the device (extract cells)."""


def read(ctx):
    if ctx.trace is None or "extract_out_bytes" not in ctx.counters:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
