"""Kernel ops/bitpack.py + csrc/chunk_pack.cu: its share of the memory
roofline over the window."""

from jxlbench.metrics._roofline import share


def read(r):
    return share(r, "chunk_pack", "chunk_pack_streams_kernel")
