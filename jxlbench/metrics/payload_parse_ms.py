"""Host plane: stage `parse` per image, the payload parse with its native
LF decode (host._parse_packed) before each LF group's walk."""

from jxlbench.metrics._stage import mean_ms


def read(r):
    return mean_ms(r, "parse")
