"""Decode-side conformance oracle: JPEG XL decoding via libjxl (ctypes).

The environment ships `libjxl.so.0.7` (runtime only, no headers), so the
needed subset of the stable libjxl decoder C API is declared here by hand.
The port's copy of hydrium_tpu/utils/djxl.py: chip_smoke.py round-trips
its encodes through the reference decoder and checks their PSNR, where
libjxl loads, standing in for the `djxl` binary.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

# JxlDecoderStatus values (libjxl 0.7 decode.h)
JXL_DEC_SUCCESS = 0
JXL_DEC_ERROR = 1
JXL_DEC_NEED_MORE_INPUT = 2
JXL_DEC_NEED_IMAGE_OUT_BUFFER = 5
JXL_DEC_BASIC_INFO = 0x40
JXL_DEC_FULL_IMAGE = 0x1000

# JxlDataType
JXL_TYPE_FLOAT = 0

JXL_LITTLE_ENDIAN = 1


class JxlPixelFormat(ctypes.Structure):
    _fields_ = [
        ("num_channels", ctypes.c_uint32),
        ("data_type", ctypes.c_int),
        ("endianness", ctypes.c_int),
        ("align", ctypes.c_size_t),
    ]


_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("jxl") or "libjxl.so.0.7"
        lib = ctypes.CDLL(name)
        lib.JxlDecoderCreate.restype = ctypes.c_void_p
        lib.JxlDecoderCreate.argtypes = [ctypes.c_void_p]
        lib.JxlDecoderDestroy.argtypes = [ctypes.c_void_p]
        lib.JxlDecoderSubscribeEvents.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.JxlDecoderSetInput.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.JxlDecoderCloseInput.argtypes = [ctypes.c_void_p]
        lib.JxlDecoderProcessInput.restype = ctypes.c_int
        lib.JxlDecoderProcessInput.argtypes = [ctypes.c_void_p]
        lib.JxlDecoderGetBasicInfo.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p]
        lib.JxlDecoderImageOutBufferSize.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(JxlPixelFormat),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.JxlDecoderSetImageOutBuffer.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(JxlPixelFormat),
            ctypes.c_void_p, ctypes.c_size_t]
        _lib = lib
    return _lib


class JXLDecodeError(RuntimeError):
    pass


def decode(data: bytes) -> np.ndarray:
    """Decode a .jxl byte stream to float32 RGB [H, W, 3] in 0..1 (sRGB).

    Handles hydrium-style multi-frame tiled streams (cropped kSkipProgressive
    frames composited with kReplace blending): the image returned is the
    final composited canvas."""
    lib = _load()
    dec = lib.JxlDecoderCreate(None)
    if not dec:
        raise JXLDecodeError("JxlDecoderCreate failed")
    try:
        events = JXL_DEC_BASIC_INFO | JXL_DEC_FULL_IMAGE
        if lib.JxlDecoderSubscribeEvents(dec, events) != JXL_DEC_SUCCESS:
            raise JXLDecodeError("SubscribeEvents failed")
        buf = ctypes.create_string_buffer(data, len(data))
        if lib.JxlDecoderSetInput(dec, ctypes.cast(buf, ctypes.c_char_p),
                                  len(data)) != JXL_DEC_SUCCESS:
            raise JXLDecodeError("SetInput failed")
        lib.JxlDecoderCloseInput(dec)

        fmt = JxlPixelFormat(3, JXL_TYPE_FLOAT, JXL_LITTLE_ENDIAN, 0)
        basic_info = ctypes.create_string_buffer(512)
        xsize = ysize = 0
        out = None
        while True:
            status = lib.JxlDecoderProcessInput(dec)
            if status == JXL_DEC_ERROR:
                raise JXLDecodeError("decoder error")
            if status == JXL_DEC_NEED_MORE_INPUT:
                raise JXLDecodeError("truncated stream")
            if status == JXL_DEC_BASIC_INFO:
                if lib.JxlDecoderGetBasicInfo(dec, basic_info) != JXL_DEC_SUCCESS:
                    raise JXLDecodeError("GetBasicInfo failed")
                # struct JxlBasicInfo: have_container:i32, xsize:u32, ysize:u32
                xsize = int.from_bytes(basic_info.raw[4:8], "little")
                ysize = int.from_bytes(basic_info.raw[8:12], "little")
            elif status == JXL_DEC_NEED_IMAGE_OUT_BUFFER:
                size = ctypes.c_size_t(0)
                if lib.JxlDecoderImageOutBufferSize(
                        dec, ctypes.byref(fmt),
                        ctypes.byref(size)) != JXL_DEC_SUCCESS:
                    raise JXLDecodeError("ImageOutBufferSize failed")
                expected = xsize * ysize * 3 * 4
                if size.value != expected:
                    raise JXLDecodeError(
                        f"unexpected buffer size {size.value} != {expected}")
                out = np.empty((ysize, xsize, 3), dtype=np.float32)
                if lib.JxlDecoderSetImageOutBuffer(
                        dec, ctypes.byref(fmt),
                        out.ctypes.data_as(ctypes.c_void_p),
                        size.value) != JXL_DEC_SUCCESS:
                    raise JXLDecodeError("SetImageOutBuffer failed")
            elif status == JXL_DEC_FULL_IMAGE:
                continue  # keep the latest composited frame
            elif status == JXL_DEC_SUCCESS:
                break
            else:
                raise JXLDecodeError(f"unexpected decoder status {status}")
        if out is None:
            raise JXLDecodeError("no image produced")
        return out
    finally:
        lib.JxlDecoderDestroy(dec)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)
