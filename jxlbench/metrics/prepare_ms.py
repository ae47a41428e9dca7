"""Dispatch window: stage `prepare` per image (the hyd-prep workers'
upload, code tables and enqueue, summed over the pool's threads)."""

from jxlbench.metrics._stage import mean_ms


def read(r):
    return mean_ms(r, "prepare")
