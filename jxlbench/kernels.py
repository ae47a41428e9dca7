"""The bytes each kernel of the port must move for one image, from the
image's own geometry, frozen here so that a roofline share counts the
same work whatever implements it.

The work is counted per unit of the encode: an LF group of up to 2048^2
pixels in one-frame mode, a tile in tiled mode.  n = 3 * its 8x8 blocks
(one row per block and channel, 64 coefficient slots a row).  Each input
is read once and each output written once:
- transport_prep: per slot a u16 token, u8 cluster, u32 residue and u8
  width read and four u32 words written (24 bytes), and a u32 valid
  length per row.  The code tables (7.4 KB a launch) are left out.
- chunk_pack: both streams of the payload: 8 bytes read per field (the
  value and its width), the packed rows written at the narrow residue
  geometry, and one word of bit count per chunk: tokens in chunks of
  4096 fields into 1552 words, residues in chunks of 2048 into 784.
- frontend_tokens: the 8-bit RGB pixels read; the five token streams (8
  bytes a slot) and valid lengths written; the DC grid (4 bytes a row)
  written; one u32 preset read per 256^2 group.
Checked against PERF.md section 6's bounds in tests/test_jxlbench_kernels.py."""

from __future__ import annotations

from typing import Dict, List, Tuple

SLOTS = 64
TOK_CHUNK, TOK_OW = 4096, 1552
RES_CHUNK, RES_OW = 2048, 784


def transport_prep_bytes(n: int, pixels: int, groups: int) -> float:
    return n * SLOTS * 24 + n * 4


def chunk_pack_bytes(n: int, pixels: int, groups: int) -> float:
    fields = n * SLOTS
    return (fields * 8 + fields * (TOK_OW * 4 + 4) / TOK_CHUNK
            + fields * 8 + fields * (RES_OW * 4 + 4) / RES_CHUNK)


def frontend_tokens_bytes(n: int, pixels: int, groups: int) -> float:
    return 3 * pixels + 8 * SLOTS * n + 4 * n + 4 * n + 4 * groups


BYTES = {"transport_prep": transport_prep_bytes,
         "chunk_pack": chunk_pack_bytes,
         "frontend_tokens": frontend_tokens_bytes}


def units(height: int, width: int, tile: int) -> List[Tuple[int, int, int]]:
    """(n rows, pixels, 256^2 groups) of each unit of one image: LF
    groups of 2048^2 (tile < 0) or tiles of tile x tile."""
    side = 2048 if tile < 0 else tile
    out = []
    for y in range(0, height, side):
        for x in range(0, width, side):
            h, w = min(side, height - y), min(side, width - x)
            n = 3 * ((h + 7) // 8) * ((w + 7) // 8)
            out.append((n, h * w, ((h + 255) // 256) * ((w + 255) // 256)))
    return out


def image_bytes(height: int, width: int, tile: int) -> Dict[str, float]:
    """kernel -> the bytes it must move for one image."""
    us = units(height, width, tile)
    return {k: float(sum(f(*u) for u in us)) for k, f in BYTES.items()}
