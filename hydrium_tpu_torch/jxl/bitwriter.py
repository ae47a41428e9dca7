"""LSB-first bit writer with the JPEG XL variable-length integer codings.

Functionally equivalent to hydrium's HYDBitWriter (reference:
src/libhydrium/bitwriter.c) but redesigned for this codebase: it grows an
internal bytearray instead of implementing the fixed-buffer/overflow-spill
protocol -- output streaming back-pressure is handled at the Encoder layer,
not per bit.  All codings are bit-exact with the reference:

- write(value, bits):    LSB-first packing (bitwriter.c:110-124)
- U32 coding:            2-bit selector + offset (bitwriter.c:134-142)
- U64 coding:            variable chunks (bitwriter.c:152-172)
- enum coding:           U32 with table {0,1,2,18}/{0,0,4,6} (bitwriter.c:16-19,:192)
- zero_pad:              pad to byte boundary (bitwriter.c:126-128)
- ICC varint:            LEB128 bytes (bitwriter.c:174-180)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class U32Table:
    cpos: Sequence[int]
    upos: Sequence[int]


ENUM_TABLE = U32Table(cpos=(0, 1, 2, 18), upos=(0, 0, 4, 6))


class BitWriter:
    __slots__ = ("_buf", "_cache", "_cache_bits")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._cache = 0
        self._cache_bits = 0

    # -- core -----------------------------------------------------------

    def write(self, value: int, bits: int) -> None:
        """Append the low `bits` bits of value, LSB first."""
        if bits <= 0:
            return
        self._cache |= (value & ((1 << bits) - 1)) << self._cache_bits
        self._cache_bits += bits
        if self._cache_bits >= 64:
            self._drain()

    def _drain(self) -> None:
        while self._cache_bits >= 8:
            self._buf.append(self._cache & 0xFF)
            self._cache >>= 8
            self._cache_bits -= 8

    def zero_pad(self) -> None:
        """Pad with zero bits to the next byte boundary."""
        if self._cache_bits & 7:
            self.write(0, 8 - (self._cache_bits & 7))

    def write_bool(self, flag: bool) -> None:
        self.write(1 if flag else 0, 1)

    def write_u32(self, table: U32Table, value: int) -> None:
        for i in range(4):
            vmc = value - table.cpos[i]
            if 0 <= vmc <= (1 << table.upos[i]) - 1:
                self.write((vmc << 2) | i, table.upos[i] + 2)
                return
        raise ValueError(f"value {value} not encodable with {table}")

    def write_enum(self, value: int) -> None:
        if value > 63:
            raise ValueError("enum value too large")
        self.write_u32(ENUM_TABLE, value)

    def write_u64(self, value: int) -> None:
        if value == 0:
            self.write(0, 2)
            return
        if value < 17:
            self.write(((value - 1) << 2) | 1, 6)
            return
        if value < 273:
            self.write(((value - 17) << 2) | 2, 10)
            return
        self.write(((value & 0xFFF) << 2) | 3, 14)
        shift = 12
        while True:
            svalue = value >> shift
            if svalue == 0:
                self.write(0, 1)
                return
            if shift == 60:
                self.write(((svalue & 0xF) << 1) | 1, 5)
                return
            self.write(((svalue & 0xFF) << 1) | 1, 9)
            shift += 8

    def write_icc_varint(self, value: int) -> None:
        while value > 0x7F:
            self.write((value & 0x7F) | 0x80, 8)
            value >>= 7
        self.write(value & 0x7F, 8)

    # -- composition ----------------------------------------------------

    @property
    def bit_position(self) -> int:
        return len(self._buf) * 8 + self._cache_bits

    def append_bytes(self, data: bytes) -> None:
        """Append whole bytes.  Requires byte alignment for the fast path;
        falls back to bit-wise writes otherwise (bitwriter.c:80-108)."""
        self._drain()
        if self._cache_bits == 0:
            self._buf.extend(data)
        else:
            for b in data:
                self.write(b, 8)

    def append_writer(self, other: "BitWriter") -> None:
        """Drain another writer's full contents (bytes + partial cache)
        into this one at the current bit position."""
        other._drain()
        self.append_bytes(bytes(other._buf))
        self.write(other._cache, other._cache_bits)

    def export_raw(self):
        """(whole_bytes, tail_value, tail_bits) without padding -- the
        unaligned-section export NativeBitWriter also provides."""
        self._drain()
        return bytes(self._buf), self._cache, self._cache_bits

    def finalize(self) -> bytes:
        """Zero-pad to a byte boundary and return the buffer."""
        self.zero_pad()
        self._drain()
        assert self._cache_bits == 0
        return bytes(self._buf)

    def __len__(self) -> int:
        """Bytes written so far (not counting a partial byte)."""
        return len(self._buf) + self._cache_bits // 8
