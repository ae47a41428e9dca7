"""Kernel ops/frontend.py + csrc/frontend.cu (the fused front with its
tokens epilogue): its share of the memory roofline over the window."""

from jxlbench.metrics._roofline import share


def read(r):
    return share(r, "frontend_tokens", "frontend_kernel")
