"""The control of the comparison: the reference front put in the
program's place and computed one precision below the configuration's
(float32 with TF32 off -> TF32).  Its DCT runs as float32 matrix
products whose inputs are rounded to TF32's 10-bit mantissa, as the
tensor cores round them, with TF32 allowed on a card (the rounding makes
the CPU, which has no TF32, and a card that picks a non-tensor-core
kernel for 8x8 products compute the same thing).  It must come out as
not correct."""

from __future__ import annotations

import numpy as np
import torch

from . import tables as T
from .front import blocks, quant_inputs, xyb_u8


def _to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 value (10 mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000 + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def quantize(u_lf: np.ndarray, u_hf: np.ndarray):
    """The encoder's quantizer: HF trunc with |q| < 2 -> 0, LF trunc."""
    q_hf = np.trunc(u_hf).astype(np.int64)
    q_hf[np.abs(q_hf) < 2] = 0
    q_hf[..., 0, :] = 0
    return np.trunc(u_lf).astype(np.int64), q_hf


def control_q(img: np.ndarray, device) -> tuple:
    """(q_lf, q_hf) of the TF32 control for one u8 image."""
    dev = torch.device(device)
    xyb = torch.from_numpy(blocks(xyb_u8(img)).astype(np.float32)).to(dev)
    basis = torch.from_numpy(T.DCT_BASIS).to(dev)
    on_card = dev.type == "cuda"
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on_card
    try:
        b = _to_tf32(basis)
        t = torch.matmul(_to_tf32(xyb), b.T)               # along x
        coeffs = torch.matmul(b, _to_tf32(t))              # along y
        if on_card:
            torch.cuda.synchronize(dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    u_lf, u_hf = quant_inputs(coeffs.cpu().numpy())
    return quantize(u_lf, u_hf)
