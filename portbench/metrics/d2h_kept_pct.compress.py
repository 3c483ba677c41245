"""Share, in %, of the card-to-host bytes that the program keeps: the
port's `d2h_kept_bytes` (the streams sliced out of C2's work buffer) over
its `d2h_bytes` (the whole work buffer, `start` and `status`), counted in
its `crilayla.d2h` spans of the window (compress cells; spans.py)."""
from portbench import spans


def read(ctx):
    s = spans.load(ctx, "compress")
    if s is None:
        return None
    moved = s.count("d2h_bytes")
    return 100.0 * s.count("d2h_kept_bytes") / moved if moved else None
