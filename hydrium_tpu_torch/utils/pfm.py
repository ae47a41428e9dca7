"""Portable FloatMap (PFM) read/write (the port's copy of
hydrium_tpu/utils/pfm.py).

Capability twin of the reference CLI's hand-rolled PFM parser
(src/hydrium.c:192-252): 'PF' color maps, arbitrary whitespace in the
header, scale sign giving endianness, bottom-up row order."""

from __future__ import annotations

import numpy as np


def read_pfm(path_or_file) -> np.ndarray:
    """Read a color PFM into float32 [H, W, 3] (top-down)."""
    f = (open(path_or_file, "rb")
         if isinstance(path_or_file, (str, bytes)) else path_or_file)
    close = isinstance(path_or_file, (str, bytes))
    try:
        magic = f.read(2)
        if magic != b"PF":
            raise ValueError("not a color PFM (expected 'PF')")

        def token():
            # skip whitespace, read one token
            t = b""
            while True:
                c = f.read(1)
                if not c:
                    raise ValueError("truncated PFM header")
                if c.isspace():
                    if t:
                        return t
                    continue
                t += c

        width = int(token())
        height = int(token())
        scale = float(token())
        # exactly one whitespace byte after the scale was consumed by token()
        data = f.read(width * height * 3 * 4)
        if len(data) != width * height * 3 * 4:
            raise ValueError("truncated PFM data")
        dt = "<f4" if scale < 0 else ">f4"
        img = np.frombuffer(data, dtype=dt).reshape(height, width, 3)
        return np.ascontiguousarray(img[::-1]).astype(np.float32)
    finally:
        if close:
            f.close()


class PFMRowReader:
    """Streaming row reader over a seekable PFM file: one strip resident
    at a time, top-down rows despite PFM's bottom-up storage (row y
    lives at a computable file offset, so each strip is one seek+read --
    the bounded-memory twin of the reference CLI's per-row PFM loop,
    hydrium.c:423-443).  Requires a real file (stdin PFM falls back to a
    whole-image read in the CLI)."""

    fmt = "float32"

    def __init__(self, path: str) -> None:
        self._f = open(path, "rb")
        magic = self._f.read(2)
        if magic != b"PF":
            self._f.close()
            raise ValueError("not a color PFM (expected 'PF')")

        def token():
            t = b""
            while True:
                c = self._f.read(1)
                if not c:
                    raise ValueError("truncated PFM header")
                if c.isspace():
                    if t:
                        return t
                    continue
                t += c

        self.width = int(token())
        self.height = int(token())
        scale = float(token())
        self._dt = "<f4" if scale < 0 else ">f4"
        self._data0 = self._f.tell()
        self._rowbytes = self.width * 12
        self._row = 0

    def read_rows(self, n: int) -> np.ndarray:
        n = min(n, self.height - self._row)
        if n <= 0:
            return np.zeros((0, self.width, 3), np.float32)
        # top-down row y is stored as bottom-up row (height-1-y)
        first_stored = self.height - (self._row + n)
        self._f.seek(self._data0 + first_stored * self._rowbytes)
        data = self._f.read(n * self._rowbytes)
        if len(data) != n * self._rowbytes:
            raise ValueError("truncated PFM data")
        img = np.frombuffer(data, dtype=self._dt).reshape(n, self.width, 3)
        self._row += n
        return np.ascontiguousarray(img[::-1]).astype(np.float32)

    def close(self) -> None:
        self._f.close()


def write_pfm(path, image: np.ndarray) -> None:
    image = np.asarray(image, dtype=np.float32)
    h, w = image.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n%d %d\n-1.0\n" % (w, h))
        f.write(np.ascontiguousarray(image[::-1]).astype("<f4").tobytes())
