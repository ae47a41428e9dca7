"""hydrium-tpu's streaming JPEG XL encoder with a PyTorch device plane.

A port of the `hydrium_tpu` package's device half to PyTorch and CUDA
(NVIDIA Hopper).  The JAX package stays the reference; this package
imports its jax-free host plane (JPEG XL serialization, the C++ walker,
frame assembly) and never imports jax.

This slice covers the one-frame packed encode path: `Encoder` and
`encode_image` in one-frame mode, with the hand-written CUDA kernels
for transport prep and chunk packing (`ops/`, `csrc/`).
"""

from hydrium_tpu.utils.stats import EncodeStats

from .encoder import Encoder, encode_image

__all__ = ["EncodeStats", "Encoder", "encode_image"]
