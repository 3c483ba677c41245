"""Host bytes written a source byte: the port's `host_bytes` (fresh host
buffers its stages fill: the join and copy of `crilayla.pack`, the
`.tobytes()` and concatenations of `crilayla.collect`) over the
`source_bytes` its root spans count, over the window (compress cells;
spans.py)."""
from portbench import spans


def read(ctx):
    s = spans.load(ctx, "compress")
    if s is None:
        return None
    source, host = s.count("source_bytes"), s.count("host_bytes")
    return host / source if source and host else None
