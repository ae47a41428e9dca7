"""hydrium-tpu's streaming JPEG XL encoder with a PyTorch device plane.

A port of the `hydrium_tpu` package to PyTorch and CUDA (NVIDIA
Hopper).  The JAX package stays the reference; this package imports
nothing of it and never imports jax.  It keeps its own copy of the host
plane it needs (JPEG XL serialization in `jxl/`, with the C++ walker and
rANS in `csrc/host/serializer.cc`; the payload parser in `host.py`;
frame assembly in `encoder.py`).

It covers the packed encode path in one-frame and tiled mode: `Encoder`
(send_tile, send_tile_batch) and `encode_image`, with hand-written CUDA
kernels for the fused front, transport prep and chunk packing (`ops/`,
`csrc/`).
"""

from .config import ImageMetadata, SampleFormat
from .encoder import Encoder, encode_image
from .utils.stats import EncodeStats

__all__ = ["EncodeStats", "Encoder", "ImageMetadata", "SampleFormat",
           "encode_image"]
