"""JPEG XL image-level headers: signature, SizeHeader, ImageMetadata
bundle, ICC payload stream, and the level-10 container prefix.

Field-for-field equivalent of the reference's write_header
(encoder.c:164-239) and ICC helpers (encoder.c:122-162,
libhydrium.c:205-305)."""

from __future__ import annotations

from typing import Optional

from .bitwriter import BitWriter, U32Table
from .entropy import EntropyStream

# ISOBMFF container prefix forcing codestream level 10 (encoder.c:23-30).
LEVEL10_HEADER = bytes([
    0x00, 0x00, 0x00, 0x0C, 0x4A, 0x58, 0x4C, 0x20,
    0x0D, 0x0A, 0x87, 0x0A, 0x00, 0x00, 0x00, 0x14,
    0x66, 0x74, 0x79, 0x70, 0x6A, 0x78, 0x6C, 0x20,
    0x00, 0x00, 0x00, 0x00, 0x6A, 0x78, 0x6C, 0x20,
    0x00, 0x00, 0x00, 0x09, 0x6A, 0x78, 0x6C, 0x6C, 0x0A,
    0x00, 0x00, 0x00, 0x00, 0x6A, 0x78, 0x6C, 0x63,
])

SIZE_HEADER_U32 = U32Table(cpos=(1, 1, 1, 1), upos=(9, 13, 18, 30))

# Contexts for the ICC byte stream (encoder.c:122-162).
ICC_CLUSTER_MAP = (
    [0, 1, 2, 3, 4, 5, 6, 7, 8]
    + [1, 2, 3, 4, 5, 6, 7, 8] * 4
)


def icc_context(i: int, b1: int, b2: int) -> int:
    if i <= 128:
        return 0
    if (ord("a") <= b1 <= ord("z")) or (ord("A") <= b1 <= ord("Z")):
        p1 = 0
    elif (ord("0") <= b1 <= ord("9")) or b1 in (ord("."), ord(",")):
        p1 = 1
    elif b1 <= 1:
        p1 = b1 + 2
    elif 1 < b1 < 16:
        p1 = 4
    elif 240 < b1 < 255:
        p1 = 5
    elif b1 == 255:
        p1 = 6
    else:
        p1 = 7
    if (ord("a") <= b2 <= ord("z")) or (ord("A") <= b2 <= ord("Z")):
        p2 = 0
    elif (ord("0") <= b2 <= ord("9")) or b2 in (ord("."), ord(",")):
        p2 = 1
    elif b2 < 16:
        p2 = 2
    elif b2 > 240:
        p2 = 3
    else:
        p2 = 4
    return 1 + p1 + p2 * 8


def write_image_header(bw: BitWriter, width: int, height: int,
                       level10: bool,
                       icc_data: Optional[bytes] = None) -> None:
    """Signature + SizeHeader + ImageMetadata (+ ICC), byte-padded.

    encoder.c:164-239."""
    if level10:
        bw.append_bytes(LEVEL10_HEADER)

    bw.write(0x0AFF, 17)  # signature FF 0A + div8=0
    bw.write_u32(SIZE_HEADER_U32, height)
    bw.write(0, 3)        # ratio
    bw.write_u32(SIZE_HEADER_U32, width)

    bw.write_bool(False)  # all_default
    bw.write_bool(False)  # extra_fields
    bw.write_bool(False)  # float samples
    bw.write(0, 2)        # 8-bit depth
    bw.write_bool(True)   # modular 16-bit buffers
    bw.write(0, 2)        # extra channels = 0
    bw.write_bool(True)   # xyb encoded

    if icc_data is not None:
        bw.write_bool(False)  # color all_default
        bw.write_bool(True)   # want_icc
        bw.write_enum(0)      # ColorSpace kRGB
    else:
        bw.write_bool(True)   # color all_default

    bw.write_u64(0)       # extensions
    bw.write_bool(True)   # default transform matrix

    if icc_data is not None:
        bw.write_u64(len(icc_data))
        stream = EntropyStream(ICC_CLUSTER_MAP, 41)
        b1 = b2 = 0
        for i, byte in enumerate(icc_data):
            stream.send_symbol(icc_context(i, b1, b2), byte)
            b2 = b1
            b1 = byte
        stream.prefix_finalize(bw)

    bw.zero_pad()


def _icc_header_predict(header: bytes, icc_size: int, i: int) -> int:
    """Predicted ICC header byte (libhydrium.c:205-240)."""
    if i < 4:
        return (icc_size >> (8 * (3 - i))) & 0xFF
    if i == 8:
        return 4
    if 12 <= i < 24:
        return b"mntrRGB XYZ "[i - 12]
    if 36 <= i < 40:
        return b"acsp"[i - 36]
    if 41 <= i < 44:
        if header[40] == ord("A"):
            return b"PPL"[i - 41]
        if header[40] == ord("M"):
            return b"SFT"[i - 41]
        # the reference reads "I "[i-42] even at i=41 (out-of-bounds in C,
        # a negative index in Python); the JXL spec predictor yields 0 at
        # i=41 for 'S' platforms, which is what decoders reconstruct with
        if header[40] == ord("S") and i >= 42:
            if header[41] == ord("G"):
                return b"I "[i - 42]
            if header[41] == ord("U"):
                return b"NW"[i - 42]
    if i == 70:
        return 246
    if i == 71:
        return 214
    if i == 73:
        return 1
    if i == 78:
        return 211
    if i == 79:
        return 45
    if 80 <= i < 84:
        return header[i - 76]
    return 0


def mangle_icc_profile(icc_data: bytes) -> bytes:
    """Produce the 'mangled' ICC payload stored in the codestream:
    size varints + command stream + predicted-header residuals + tail
    (libhydrium.c:242-305)."""
    icc_size = len(icc_data)
    bw = BitWriter()
    header_size = min(icc_size, 128)
    header = bytes(
        (icc_data[i] - _icc_header_predict(icc_data, icc_size, i)) & 0xFF
        for i in range(header_size))
    remaining_size = icc_size - header_size
    bw.write_icc_varint(icc_size)
    bw.write_icc_varint(
        3 + (remaining_size.bit_length() - 1) // 7 if remaining_size else 0)
    if remaining_size:
        bw.write_icc_varint(0)   # taglist length
        bw.write(1, 8)           # command 1: raw copy
        bw.write_icc_varint(remaining_size)
    bw.zero_pad()
    bw.append_bytes(header)
    if remaining_size:
        bw.append_bytes(icc_data[header_size:])
    return bw.finalize()
