"""Streaming PNG reader: one tile-row strip resident at a time (the
port's copy of hydrium_tpu/utils/pngio.py).

The reference CLI's bounded-memory story *includes the input*: it
decodes PNG row-by-row via libspng so only one tile strip of pixels is
ever resident (hydrium.c:407-422).  This module is the equivalent --
pure-stdlib chunk walking + incremental zlib inflate, with the
per-scanline defilter hot loop in the native plane
(csrc/host/serializer.cc hyd_png_unfilter; a Python fallback exists for
environments without a compiler).

Supports non-interlaced PNGs, bit depth 8/16, color types gray(0),
RGB(2), palette(3), gray+alpha(4), RGBA(6).  Output rows are always
[n, width, 3] uint8 or uint16 (alpha stripped, gray/palette expanded) --
the shape hydrium's tile contract consumes.  Interlaced (Adam7) files
are rare for large images; callers fall back to PIL for them."""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Optional

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter_py(cur: bytearray, prev: Optional[bytes], bpp: int,
                 filt: int) -> None:
    """Pure-Python defilter fallback (slow; native plane preferred)."""
    n = len(cur)
    if filt == 0:
        return
    if filt == 1:
        for i in range(bpp, n):
            cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
    elif filt == 2:
        if prev:
            for i in range(n):
                cur[i] = (cur[i] + prev[i]) & 0xFF
    elif filt == 3:
        for i in range(n):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i] if prev else 0
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
    elif filt == 4:
        for i in range(n):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i] if prev else 0
            c = prev[i - bpp] if (prev and i >= bpp) else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    else:
        raise ValueError(f"bad PNG filter {filt}")


class PNGReader:
    """Incremental row reader over a seekless binary stream."""

    # inflate at most this much ahead of the consumer: keeps residency
    # at ~one strip even for PNGs written as a single giant IDAT chunk
    MAX_INFLATE_AHEAD = 8 << 20

    def __init__(self, f: BinaryIO) -> None:
        self._f = f
        if f.read(8) != _SIG:
            raise ValueError("not a PNG file")
        self._inflate = zlib.decompressobj()
        self._pending = bytearray()  # inflated bytes not yet consumed
        self._pend_off = 0           # consumed prefix of _pending
        self._ztail = b""            # compressed bytes awaiting inflate
        self._chunks_done = False
        self._palette: Optional[np.ndarray] = None
        self._row_read = 0
        # IHDR must be first
        length, ctype, data = self._next_chunk()
        if ctype != b"IHDR":
            raise ValueError("missing IHDR")
        if len(data) != 13:
            raise ValueError("bad IHDR length")
        (self.width, self.height, self.bit_depth, self.color_type,
         comp, filt, interlace) = struct.unpack(">IIBBBBB", data)
        if comp != 0 or filt != 0:
            raise ValueError("unsupported PNG compression/filter method")
        if interlace != 0:
            raise ValueError("interlaced PNG not supported (use PIL)")
        if self.bit_depth not in (8, 16):
            raise ValueError(f"bit depth {self.bit_depth} not supported")
        if self.color_type not in _CHANNELS:
            raise ValueError(f"color type {self.color_type} not supported")
        if self.color_type == 3 and self.bit_depth != 8:
            raise ValueError("palette PNGs must be 8-bit")
        self.channels = _CHANNELS[self.color_type]
        self._bpp = self.channels * (self.bit_depth // 8)
        self._rowbytes = self.width * self._bpp
        self._prev_arr: Optional[np.ndarray] = None
        self.fmt = "uint16" if self.bit_depth == 16 else "uint8"

    # -- chunk / inflate plumbing --------------------------------------

    def _next_chunk(self):
        hdr = self._f.read(8)
        if len(hdr) < 8:
            raise ValueError("truncated PNG")
        length, ctype = struct.unpack(">I4s", hdr)
        data = self._f.read(length)
        if len(data) != length:
            raise ValueError("truncated PNG chunk")
        self._f.read(4)  # CRC (not verified; zlib adler catches corruption)
        return length, ctype, data

    def _more_inflated(self) -> bool:
        """Inflate up to MAX_INFLATE_AHEAD more bytes; False at end.
        Bounded: a single giant IDAT chunk is inflated incrementally via
        max_length + unconsumed_tail, never materializing the image."""
        cap = self.MAX_INFLATE_AHEAD
        if self._ztail:
            out = self._inflate.decompress(self._ztail, cap)
            self._ztail = self._inflate.unconsumed_tail
            if out:
                self._pending += out
                return True
        while not self._chunks_done:
            _, ctype, data = self._next_chunk()
            if ctype == b"PLTE":
                self._palette = np.frombuffer(
                    data, np.uint8).reshape(-1, 3).copy()
            elif ctype == b"IDAT":
                out = self._inflate.decompress(data, cap)
                self._ztail = self._inflate.unconsumed_tail
                if out:
                    self._pending += out
                    return True
            elif ctype == b"IEND":
                self._chunks_done = True
                tail = self._inflate.flush()
                if tail:
                    self._pending += tail
                    return True
        return False

    def _take(self, n: int) -> bytes:
        """Next n inflated bytes (a copy -- one scanline, so O(total)
        overall; a consumed-prefix cursor avoids the O(n^2) re-slicing
        of the whole pending buffer per row)."""
        while len(self._pending) - self._pend_off < n:
            if not self._more_inflated():
                raise ValueError("PNG pixel data ended early")
        off = self._pend_off
        self._pend_off = off + n
        out = bytes(memoryview(self._pending)[off:off + n])
        if self._pend_off >= (self.MAX_INFLATE_AHEAD >> 1):
            del self._pending[:self._pend_off]
            self._pend_off = 0
        return out

    # -- row API --------------------------------------------------------

    def read_rows(self, n: int) -> np.ndarray:
        """Next n scanlines -> [n, width, 3] uint8/uint16 RGB."""
        n = min(n, self.height - self._row_read)
        if n <= 0:
            return np.zeros((0, self.width, 3),
                            np.uint16 if self.bit_depth == 16 else np.uint8)
        from ..jxl import native

        fast = native.available()
        rows = np.empty((n, self._rowbytes), np.uint8)
        for r in range(n):
            raw = self._take(1 + self._rowbytes)
            filt = raw[0]
            rows[r] = np.frombuffer(raw, np.uint8, count=self._rowbytes,
                                    offset=1)
            if fast:
                native.png_unfilter(rows[r], self._prev_arr, self._bpp, filt)
            else:
                cur = bytearray(rows[r].tobytes())
                _unfilter_py(cur, None if self._prev_arr is None
                             else self._prev_arr.tobytes(), self._bpp, filt)
                rows[r] = np.frombuffer(bytes(cur), np.uint8)
            self._prev_arr = rows[r]   # contiguous row view
        self._row_read += n
        return self._to_rgb(rows)

    def _to_rgb(self, rows: np.ndarray) -> np.ndarray:
        n = rows.shape[0]
        if self.bit_depth == 16:
            px = rows.reshape(n, self.width, self.channels, 2)
            arr = (px[..., 0].astype(np.uint16) << 8) | px[..., 1]
        else:
            arr = rows.reshape(n, self.width, self.channels)
        ct = self.color_type
        if ct == 2:
            return np.ascontiguousarray(arr)
        if ct == 6:
            return np.ascontiguousarray(arr[..., :3])
        if ct in (0, 4):
            return np.repeat(arr[..., :1], 3, axis=-1)
        if ct == 3:
            if self._palette is None:
                raise ValueError("palette PNG without PLTE")
            return self._palette[arr[..., 0]]
        raise AssertionError


def read_png(f: BinaryIO) -> np.ndarray:
    """Whole-image convenience wrapper (tests / small files)."""
    r = PNGReader(f)
    return r.read_rows(r.height)
