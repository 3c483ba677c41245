"""C1's least time over its device time, in %: each compressed byte
(stream and raw prefix) read once and each decompressed byte written once
at the card's HBM rate (peaks.json), over the device time of C1's kernels
(chip_smoke.py's C1 byte count)."""


def read(ctx):
    if (ctx.trace is None or ctx.peak is None
            or "extract_out_bytes" not in ctx.counters):
        return None
    s = ctx.trace.device_seconds(lambda n: n.startswith("c1_"))
    if not s:
        return None
    moved = (ctx.counters["extract_in_bytes"]
             + ctx.counters["extract_out_bytes"])
    return 100.0 * moved / ctx.peak["hbm_bytes_per_s"] / s
