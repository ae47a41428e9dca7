"""Kernel ops/transport.py + csrc/transport_prep.cu: its share of the
memory roofline over the window."""

from jxlbench.metrics._roofline import share


def read(r):
    return share(r, "transport_prep", "transport_prep_kernel")
