"""Numpy reference pipeline with exact float32 semantics (the port's
copy of hydrium_tpu/ops/reference.py).

This is the *conformance* math path, the plane behind
Encoder(backend="numpy") / profile="conformance": every operation
replicates the reference encoder's arithmetic (operation order, float32
width, integer truncation) so quantized integers -- and therefore
bitstreams -- are byte-identical to hydrium's.  It is elementwise numpy
with no BLAS, so it gives the same bits on any machine.  The PyTorch
device plane (ops/front.py and the CUDA kernels) computes in direct
float math and is not held to it.

Parity notes (reference citations):
- sRGB linearization polynomial             format.c:15-19
- inverse-cbrt bit hack                     format.c:21-27
- LMS bias cbrt(x+b)-c                      format.c:29-31
- u8/u16 LUT paths, exact integer mixing    format.c:48-83
- float path matrix                         format.c:38-46
- two-pass 8x8 DCT, stored transposed       encoder.c:631-668
- LF quantization + clamped-gradient pred   encoder.c:567-594
- HF quantization, dead zone |q|<2          encoder.c:786-823
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

from . import tables

f32 = np.float32


def linearize(x: np.ndarray) -> np.ndarray:
    """sRGB EOTF cubic approximation (format.c:15-19)."""
    x = x.astype(np.float32, copy=False)
    lo = f32(0.07739938080495357) * x
    hi = f32(0.003094300919832) + x * (
        f32(-0.009982599) + x * (f32(0.72007737769) + f32(0.2852804880) * x))
    return np.where(x <= f32(0.0404482362771082), lo, hi)


def fast_cbrtf(x: np.ndarray) -> np.ndarray:
    """Bit-hack float32 cube root (format.c:21-27)."""
    x = x.astype(np.float32, copy=False)
    zi = x.view(np.uint32)
    zi = (np.uint32(0x548C39CB) - zi // np.uint32(3)).astype(np.uint32)
    z = zi.view(np.float32)
    z = z * (f32(1.5015480449) - f32(0.534850249) * x * z * z * z)
    z = z * (f32(1.333333985) - f32(0.33333333) * x * z * z * z)
    return f32(1.0) / z


def bias_func(x: np.ndarray) -> np.ndarray:
    """cbrt(x + bias) - cbrt(bias)-ish offset (format.c:29-31)."""
    return fast_cbrtf(x.astype(np.float32, copy=False)
                      + f32(0.0037930732552754493)) - f32(0.155954)


def f32_to_u16(x: np.ndarray) -> np.ndarray:
    y = (x * f32(65535.0) + f32(0.5)).astype(np.int32)
    return np.clip(y, 0, 65535).astype(np.uint16)


@lru_cache(maxsize=4)
def input_lut(bits: int, need_linearize: bool) -> np.ndarray:
    """u8/u16 sample -> u16 linear-light LUT (format.c:58-71)."""
    size = 1 << bits
    factor = f32(1.0) / f32(size - 1.0)
    f = np.arange(size, dtype=np.float32) * factor
    return f32_to_u16(linearize(f) if need_linearize else f)


@lru_cache(maxsize=1)
def bias_lut() -> np.ndarray:
    """u16 mixed-LMS value -> biased-cbrt float LUT (format.c:73-83)."""
    factor = f32(1.0) / f32(65535.0)
    return bias_func(np.arange(65536, dtype=np.float32) * factor)


def rgb_to_xyb_int(rgb_u16: np.ndarray) -> np.ndarray:
    """Fixed-point LMS mix + bias LUT + XYB rotation (format.c:48-56).

    rgb_u16: [..., 3] uint16 linear samples -> float32 XYB [..., 3]."""
    r = rgb_u16[..., 0].astype(np.uint32)
    g = rgb_u16[..., 1].astype(np.uint32)
    b = rgb_u16[..., 2].astype(np.uint32)
    lut = bias_lut()
    lm = lut[((19661 * r + 40761 * g + 5112 * b) >> 16) & 0xFFFF]
    mm = lut[((15073 * r + 45350 * g + 5112 * b) >> 16) & 0xFFFF]
    sm = lut[((15953 * r + 13419 * g + 36163 * b) >> 16) & 0xFFFF]
    y = (lm + mm) * f32(0.5)
    x = y - mm
    bb = sm - y
    return np.stack([x, y, bb], axis=-1)


def rgb_to_xyb_float(rgb: np.ndarray, need_linearize: bool) -> np.ndarray:
    """Float path (format.c:38-46, :111-140)."""
    rgb = rgb.astype(np.float32, copy=False)
    if not np.all(np.isfinite(rgb)):
        raise ValueError("Invalid NaN Float")
    if need_linearize:
        rgb = linearize(rgb)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    lgamma = bias_func(f32(0.3) * r + f32(0.622) * g + f32(0.078) * b)
    mgamma = bias_func(f32(0.23) * r + f32(0.692) * g + f32(0.078) * b)
    sgamma = bias_func(f32(0.243423) * r + f32(0.204767) * g + f32(0.55181) * b)
    y = (lgamma + mgamma) * f32(0.5)
    x = y - mgamma
    bb = sgamma - y
    return np.stack([x, y, bb], axis=-1)


def pixels_to_xyb(image: np.ndarray, sample_fmt: str,
                  linear_light: bool) -> np.ndarray:
    """[H, W, 3] samples -> [H, W, 3] float32 XYB, matching hydrium's
    per-format path selection (format.c:142-181)."""
    if sample_fmt == "uint8":
        lut = input_lut(8, not linear_light)
        return rgb_to_xyb_int(lut[image.astype(np.uint8)])
    if sample_fmt == "uint16":
        lut = input_lut(16, not linear_light)
        return rgb_to_xyb_int(lut[image.astype(np.uint16)])
    if sample_fmt == "float32":
        return rgb_to_xyb_float(image, not linear_light)
    raise ValueError("Invalid Sample Format")


def pad_to_blocks(xyb: np.ndarray, height: int, width: int) -> np.ndarray:
    """Zero-pad [h, w, 3] to 8-multiples (format.c:182-191)."""
    vh = (height + 7) >> 3
    vw = (width + 7) >> 3
    out = np.zeros((vh * 8, vw * 8, 3), dtype=np.float32)
    out[:height, :width] = xyb[:height, :width]
    return out


def forward_dct(xyb: np.ndarray) -> np.ndarray:
    """Batched two-pass 8x8 DCT with hydrium's exact accumulation order.

    xyb: [H, W, 3] float32 (H, W multiples of 8)
    returns F: [vh, vw, 8(ky), 8(kx), 3] float32 standard frequency layout
    (the reference's transposed in-place storage is represented by the
    zig-zag gather in `zigzag_gather`; encoder.c:631-668)."""
    h, w, _ = xyb.shape
    vh, vw = h // 8, w // 8
    blocks = xyb.reshape(vh, 8, vw, 8, 3).transpose(0, 2, 1, 3, 4)
    lut = tables.COSINE_LUT

    # pass 1: DCT along x -> t[..., y, k, c]
    t = np.empty_like(blocks)
    acc = blocks[..., :, 0, :].copy()
    for x in range(1, 8):
        acc = acc + blocks[..., :, x, :]
    t[..., :, 0, :] = acc * f32(0.125)
    for k in range(1, 8):
        acc = blocks[..., :, 0, :] * lut[k - 1, 0]
        for n in range(1, 8):
            acc = acc + blocks[..., :, n, :] * lut[k - 1, n]
        t[..., :, k, :] = acc

    # pass 2: DCT along y -> F[..., ky, kx, c]
    out = np.empty_like(blocks)
    acc = t[..., 0, :, :].copy()
    for y in range(1, 8):
        acc = acc + t[..., y, :, :]
    out[..., 0, :, :] = acc * f32(0.125)
    for k in range(1, 8):
        acc = t[..., 0, :, :] * lut[k - 1, 0]
        for n in range(1, 8):
            acc = acc + t[..., n, :, :] * lut[k - 1, n]
        out[..., k, :, :] = acc
    return out


def zigzag_gather(coeffs: np.ndarray) -> np.ndarray:
    """[vh, vw, 8, 8, 3] -> [vh, vw, 64, 3] in hydrium's emission order
    (transposed zig-zag; see tables.ZIGZAG_KY)."""
    return coeffs[:, :, tables.ZIGZAG_KY, tables.ZIGZAG_KX, :]


def quantize_hf(zz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """HF quantization with dead zone (encoder.c:802-818).

    zz: [vh, vw, 64, 3] float32 zig-zag coefficients.
    Returns (hf_q [vh, vw, 64, 3] int32 with slot 0 zeroed,
             nz [vh, vw, 3] int32 per-block nonzero AC counts)."""
    w = tables.HF_QUANT_WEIGHTS.T.astype(np.float32)  # [64, 3]
    q = ((zz * w) * f32(tables.HF_MULT)).astype(np.int32)
    q = np.where(np.abs(q) < 2, 0, q)
    q[:, :, 0, :] = 0
    nz = np.count_nonzero(q, axis=2).astype(np.int32)
    return q, nz


def quantize_lf(dc: np.ndarray) -> np.ndarray:
    """LF quantization: truncating int cast of dc * shift (encoder.c:582).

    dc: [vh, vw, 3] float32 -> int32."""
    return (dc * tables.LF_SHIFT).astype(np.int32)


def lf_predict_residuals(lf_q: np.ndarray) -> np.ndarray:
    """Clamped-gradient prediction residuals (encoder.c:583-591).

    lf_q: [vh, vw, 3] int32 -> residuals [vh, vw, 3] int32 (value - pred)."""
    v = lf_q.astype(np.int64)
    left = np.empty_like(v)
    left[:, 1:] = v[:, :-1]
    left[:, 0] = 0
    up = np.empty_like(v)
    up[1:] = v[:-1]
    up[0] = 0
    upleft = np.empty_like(v)
    upleft[1:, 1:] = v[:-1, :-1]
    upleft[0] = 0
    upleft[:, 0] = 0

    has_x = np.zeros(v.shape, dtype=bool)
    has_x[:, 1:] = True
    has_y = np.zeros(v.shape, dtype=bool)
    has_y[1:] = True

    w = np.where(has_x, left, np.where(has_y, up, 0))
    n = np.where(has_y, up, w)
    nw = np.where(has_x & has_y, upleft, w)
    vp = w + n - nw
    vmin = np.minimum(w, n)
    vmax = np.maximum(w, n)
    pred = np.clip(vp, vmin, vmax)
    return (v - pred).astype(np.int32)


def pack_signed(v: np.ndarray) -> np.ndarray:
    """Zig-zag signed->unsigned map (math-functions.h:69-72)."""
    v = v.astype(np.int64)
    return np.where(v >= 0, v << 1, (-v << 1) - 1).astype(np.uint32)
