"""HCA stream constants and loop-point math shared by the WAV writers."""
from __future__ import annotations

SAMPLES_PER_FRAME = 1024


def loop_points(info) -> tuple:
    """(looping, loop_start, loop_end) in output samples (hca.cpp:3372-3373)."""
    if not info.loop_flag:
        return False, 0, 0
    loop_start = (info.loop_start_frame * SAMPLES_PER_FRAME
                  + info.loop_start_delay - info.encoder_delay)
    loop_end = (info.loop_end_frame * SAMPLES_PER_FRAME
                + (SAMPLES_PER_FRAME - info.loop_end_padding)
                - info.encoder_delay)
    return True, loop_start, loop_end
