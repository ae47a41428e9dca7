"""Host plane: stages `walk` and `ans_encode` per image."""

from jxlbench.metrics._stage import mean_ms


def read(r):
    return mean_ms(r, "walk", "ans_encode")
