"""Host milliseconds a call in the host layer's own stages: the self time
of the port's spans `crilayla.pack` (the members' join and copy),
`crilayla.collect` (the streams' slices and blob assembly) and
`c2.prepare` (the wrapper's checks, tables and allocations), summed over
the window and divided by its calls (compress cells; spans.py)."""
from portbench import spans


def read(ctx):
    s = spans.load(ctx, "compress")
    own = s and s.self_intervals(spans.HOST_STAGES)
    if not own:  # no run, or the plain versions' (no stages)
        return None
    return sum(hi - lo for lo, hi in own) / 1e3 / ctx.calls
