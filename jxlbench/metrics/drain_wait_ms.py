"""Host plane: stage `drain_wait` per image, how long the drain worker
waited for each LF group's payload to come back over the link before
its parse and walk."""

from jxlbench.metrics._stage import mean_ms


def read(r):
    return mean_ms(r, "drain_wait")
