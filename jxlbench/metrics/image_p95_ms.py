"""Encoder: the 95th percentile of the images' walls (host clock, first
tile to last output, device synchronized), over every image of the
window."""

import statistics


def read(r):
    walls = [i.wall_s for i in r.window.images]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=20, method="inclusive")[18] * 1e3
