"""C2's least time over its device time, in %: each source byte read once
and each stream byte written once at the card's HBM rate (peaks.json),
over the device time of C2's kernels (chip_smoke.py's C2 byte count)."""


def read(ctx):
    if (ctx.trace is None or ctx.peak is None
            or "compress_source_bytes" not in ctx.counters):
        return None
    s = ctx.trace.device_seconds(lambda n: n.startswith("c2_"))
    if not s:
        return None
    moved = (ctx.counters["compress_source_bytes"]
             + ctx.counters["compress_stream_bytes"])
    return 100.0 * moved / ctx.peak["hbm_bytes_per_s"] / s
