"""Tile renders: stage `render_queue` per image, how long each tile's
render waited for a hyd-tile worker after it was queued (summed over
the tiles).  Silent on a one-frame run, and where the program does not
record the stage."""

from jxlbench.metrics._stage import mean_ms


def read(r):
    return mean_ms(r, "render_queue")
