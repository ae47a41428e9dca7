"""LSB-first bit reader over one JPEG XL codestream (ISO/IEC 18181-1,
section 4.2), with the U32, U64 and U8 field codings of the headers."""

from __future__ import annotations


class ParseFault(Exception):
    """The codestream breaks the format, or leaves the subset that the
    encoder under test is documented to write."""


def padded(data: bytes) -> bytes:
    return bytes(data) + bytes(8)


class BitReader:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes, start: int = 0, end: int = -1) -> None:
        """buf: the data followed by eight zero bytes (padded()), so that
        a peek never runs short; reading them is caught by check_end.
        start, end: the byte range to read."""
        self.buf = buf
        self.pos = start * 8
        self.end = (len(buf) - 8 if end < 0 else end) * 8

    def peek(self, n: int) -> int:
        p = self.pos
        return (int.from_bytes(self.buf[p >> 3:(p >> 3) + 8], "little")
                >> (p & 7)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        v = (int.from_bytes(self.buf[p >> 3:(p >> 3) + 8], "little")
             >> (p & 7)) & ((1 << n) - 1)
        self.pos = p + n
        return v

    def skip(self, n: int) -> None:
        self.pos += n

    def read_u32(self, dist) -> int:
        """dist: four (offset, bits) pairs, chosen by a 2-bit selector."""
        off, bits = dist[self.read(2)]
        return off + self.read(bits)

    def read_u64(self) -> int:
        sel = self.read(2)
        if sel == 0:
            return 0
        if sel == 1:
            return 1 + self.read(4)
        if sel == 2:
            return 17 + self.read(8)
        value = self.read(12)
        shift = 12
        while self.read(1):
            if shift == 60:
                value |= self.read(4) << shift
                break
            value |= self.read(8) << shift
            shift += 8
        return value

    def read_u8(self) -> int:
        """The entropy header's variable-length byte (18181-1 C.2.5)."""
        if not self.read(1):
            return 0
        n = self.read(3)
        return (1 << n) + self.read(n)

    def zero_pad(self) -> None:
        """Skip to the next byte; the skipped bits must be zero."""
        r = (-self.pos) & 7
        if r and self.read(r):
            raise ParseFault("non-zero padding bits")

    def check_end(self, what: str) -> None:
        if self.pos > self.end:
            raise ParseFault(f"{what}: read {self.pos - self.end} bits past "
                             "its end")

    def expect(self, bits: int, value: int, what: str) -> None:
        got = self.read(bits)
        if got != value:
            raise ParseFault(f"{what}: {got}, the encoder writes {value}")
