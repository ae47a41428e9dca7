"""Tile renders: stage `render` per image, each tile frame's walk, LF
sections, ANS and assembly on a hyd-tile worker (summed over the
workers).  Silent on a one-frame run, which renders no tile."""

from jxlbench.metrics._stage import mean_ms


def read(r):
    return mean_ms(r, "render")
