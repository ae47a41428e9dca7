"""hydrium-tpu's streaming JPEG XL encoder with a PyTorch device plane.

A port of the `hydrium_tpu` package's device half to PyTorch and CUDA
(NVIDIA Hopper).  The JAX package stays the reference; this package
imports its jax-free host plane (JPEG XL serialization, the C++ walker,
frame assembly) and never imports jax.

It covers the packed encode path in one-frame and tiled mode: `Encoder`
(send_tile, send_tile_batch) and `encode_image`, with hand-written CUDA
kernels for the fused front, transport prep and chunk packing (`ops/`,
`csrc/`).
"""

from hydrium_tpu.config import ImageMetadata, SampleFormat
from hydrium_tpu.utils.stats import EncodeStats

from .encoder import Encoder, encode_image

__all__ = ["EncodeStats", "Encoder", "ImageMetadata", "SampleFormat",
           "encode_image"]
