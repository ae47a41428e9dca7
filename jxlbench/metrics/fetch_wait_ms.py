"""Dispatch window: stage `fetch_wait` per image, the time the calling
thread was blocked on a dispatch's result."""

from jxlbench.metrics._stage import mean_ms


def read(r):
    return mean_ms(r, "fetch_wait")
