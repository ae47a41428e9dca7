"""hydrium-tpu's streaming JPEG XL encoder with a PyTorch device plane.

A port of the `hydrium_tpu` package to PyTorch and CUDA (NVIDIA
Hopper).  The JAX package stays the reference; this package imports
nothing of it and never imports jax.  It keeps its own copy of the host
plane it needs (JPEG XL serialization in `jxl/`, with the C++ walker and
rANS in `csrc/host/serializer.cc`; the payload parser in `host.py`;
frame assembly in `encoder.py`).

It covers the packed encode path in one-frame and tiled mode: `Encoder`
(send_tile, send_tile_batch), `BufferedEncoder` (caller-owned output
buffers) and `encode_image`, with hand-written CUDA kernels for the
fused front, transport prep and chunk packing (`ops/`, `csrc/`), the
command line (`python -m hydrium_tpu_torch.cli`, PNG or PFM in, .jxl
out), and multi-device and multi-process encodes (`parallel/`).

Two math planes, chosen by `backend=` or `profile=` (`models/`): the
device plane ("torch", profile "fast", the default) and the conformance
plane ("numpy", profile "conformance"; `ops/reference.py`,
`ops/hf_tokens.py`), byte-identical to hydrium_tpu's backend="numpy".
The conformance plane runs on the host alone and needs no card.
"""

from .config import (HYD_FLOAT32, HYD_UINT8, HYD_UINT16, ImageMetadata,
                     SampleFormat)
from .encoder import (NEED_MORE_OUTPUT, OK, BufferedEncoder, Encoder,
                      encode_image)
from .utils.stats import EncodeStats
from .version import __version__

__all__ = ["__version__", "ImageMetadata", "SampleFormat", "HYD_UINT8",
           "HYD_UINT16", "HYD_FLOAT32", "Encoder", "BufferedEncoder", "OK",
           "NEED_MORE_OUTPUT", "encode_image", "EncodeStats"]
