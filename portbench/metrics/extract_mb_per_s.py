"""Members' decompressed bytes in the window / the window's wall seconds,
MB = 10^6 bytes (host clock; the window holds whole calls)."""


def read(ctx):
    b = ctx.counters.get("extract_out_bytes")
    return None if b is None else b / 1e6 / ctx.window_s
