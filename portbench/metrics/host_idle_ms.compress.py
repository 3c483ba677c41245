"""Device-idle milliseconds a call under the host layer's own stages: the
window's idle intervals (trace.py's `gaps`) that lie under the self time
of the port's spans `crilayla.pack`, `crilayla.collect` and `c2.prepare`
(host_ms.compress's stages), over the window's calls (compress cells;
spans.py)."""
from portbench import spans


def read(ctx):
    s = spans.load(ctx, "compress")
    own = s and s.self_intervals(spans.HOST_STAGES)
    if not own:  # no run, or the plain versions' (no stages)
        return None
    return spans.overlap(ctx.trace.gaps(), own) / 1e3 / ctx.calls
