"""Device resolution and the float settings the front depends on.

Every entry point of the port takes an explicit `device`.  "cuda" on a
machine without a usable card raises: the port never drops to the CPU
by itself.  The CPU is a device only when the caller names it (the
tests do, at small sizes).

TF32 stays off for matrix products and for cuDNN.  The 8x8 DCT is a
float32 product, and TF32's ~10-bit mantissa would move quantization
decisions (truncations of coefficient * weight near an integer) far
more often than the summation-order differences the tests tolerate.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when it names CUDA and no card
    is available.  Also pins the float32 matmul settings (see module
    docstring) before any tensor work starts."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return d
