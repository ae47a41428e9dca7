"""The plain reference front: sRGB u8 pixels to the unrounded quantizer
inputs of every 8x8 block, in float64.

The semantics are the encoder's float path (hydrium's format.c:15-46,
the path the port's device front follows for every sample format):
samples over 255, the sRGB cubic, the opsin mix, the biased cube root,
then the 8x8 DCT over the encoder's rounded basis rows, then the
quantizer scaling.  All of it here runs in float64, so u = coefficient
* weight * hf_mult (HF) and u = DC * shift (LF) are the exact values the
encoder's truncating quantizer rounds.  Written from the format and the
encoder's constants; it imports nothing of the program under test."""

from __future__ import annotations

import numpy as np

from . import tables as T

_OPSIN = np.array([[0.3, 0.622, 0.078], [0.23, 0.692, 0.078],
                   [0.243423, 0.204767, 0.55181]])
_BIAS, _BIAS_CBRT = 0.0037930732552754493, 0.155954


def xyb_u8(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 sRGB -> [H, W, 3] float64 X, Y, B."""
    x = img.astype(np.float64) / 255.0
    lin = np.where(x <= 0.0404482362771082, 0.07739938080495357 * x,
                   0.003094300919832 + x * (-0.009982599 + x * (
                       0.72007737769 + 0.2852804880 * x)))
    lms = np.cbrt(lin @ _OPSIN.T + _BIAS) - _BIAS_CBRT
    y = (lms[..., 0] + lms[..., 1]) * 0.5
    return np.stack([y - lms[..., 1], y, lms[..., 2] - y], axis=-1)


def blocks(xyb: np.ndarray) -> np.ndarray:
    """Zero-padded [H, W, 3] -> [vh, vw, 3, 8, 8] blocks."""
    h, w, _ = xyb.shape
    vh, vw = (h + 7) // 8, (w + 7) // 8
    pad = np.zeros((vh * 8, vw * 8, 3), xyb.dtype)
    pad[:h, :w] = xyb
    return pad.reshape(vh, 8, vw, 8, 3).transpose(0, 2, 4, 1, 3)


def quant_inputs(coeffs: np.ndarray):
    """[vh, vw, 3, 8(ky), 8(kx)] DCT coefficients -> (u_lf [vh, vw, 3],
    u_hf [vh, vw, 64, 3] in zig-zag order, slot 0 unused)."""
    ky, kx = T.ZIGZAG_XY[:, 0], T.ZIGZAG_XY[:, 1]
    zz = coeffs[:, :, :, ky, kx]                        # [vh, vw, 3, 64]
    u_hf = (zz * (T.HF_WEIGHTS * T.HF_MULT)).transpose(0, 1, 3, 2)
    u_lf = coeffs[:, :, :, 0, 0] * T.LF_SHIFT
    return u_lf, u_hf


def reference_inputs(img: np.ndarray, rows: int = 64):
    """The exact quantizer inputs of a u8 image, in float64, worked out
    in bands of `rows` block rows."""
    xyb = xyb_u8(img)
    basis = T.DCT_BASIS.astype(np.float64)
    out_lf, out_hf = [], []
    for y0 in range(0, xyb.shape[0], rows * 8):
        b = blocks(xyb[y0:y0 + rows * 8]).astype(np.float64)
        coeffs = np.einsum("ay,bx,hwcyx->hwcab", basis, basis, b,
                           optimize=True)
        lf, hf = quant_inputs(coeffs)
        out_lf.append(lf)
        out_hf.append(hf)
    return np.concatenate(out_lf), np.concatenate(out_hf)
