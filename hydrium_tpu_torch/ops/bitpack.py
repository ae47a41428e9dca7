"""Bit packing of the packed payload: format-v3 word-aligned chunks for
the HF token and residue streams, plain bit-contiguous streams for the
LF residuals.  Twins of hydrium_tpu/ops/pipeline.py _chunk_layout,
_bitpack_at, _overwrite_compact, _bitpack and _bitpack64 (the CPU-branch
semantics).

pack_chunks is the wrapper of the CUDA kernel csrc/chunk_pack.cu (it
replaces the TPU kernel ops/pallas/bitpack.py::merge_pack_chunks); on a
CPU tensor it runs pack_chunks_plain.  Composed with overwrite_compact
it gives the words of chunk_layout + bitpack_at for every chunk whose
bits fit its ow-word buffer; for a chunk that overflows only the ok
word of the payload is format semantics.

Fields are (value, width) pairs with value < 2^width.  Words are u32
values in int64 (plain arithmetic) or u32 bit patterns in int32
(stored streams); see front.py.
"""

from __future__ import annotations

import torch

from . import _kernels
from .front import _MASK32, bits32, u32


def _place(num_words: int, *pairs) -> torch.Tensor:
    """Scatter-add of (word index, contribution) pairs into num_words
    u32 words (int64 values, wrapping mod 2^32).  Indices outside
    [0, num_words) are dropped."""
    words = torch.zeros(num_words + 1, dtype=torch.int64,
                        device=pairs[0][1].device)
    for idx, c in pairs:
        idx = torch.where((idx >= 0) & (idx < num_words), idx, num_words)
        words.index_add_(0, idx.reshape(-1), c.reshape(-1))
    return words[:num_words] & _MASK32


def _split(values, off):
    """Field at bit offset off -> (word, lo contribution, hi carry)."""
    v = u32(values)
    s = off & 31
    lo = (v << s) & _MASK32
    hi = torch.where(s > 0, v >> (32 - s), 0)
    return off >> 5, lo, hi


def chunk_layout(nbits: torch.Tensor, ch: int):
    """Field bit offsets of format v3's word-aligned chunking: nbits
    [F] (F % ch == 0) -> (off [F] absolute bit offset, nw [R] words per
    chunk, chunk_bits [R]), int64; chunk r starts at word sum(nw[:r])."""
    R = nbits.shape[0] // ch
    nb = nbits.reshape(R, ch).to(torch.int64)
    inc = torch.cumsum(nb, dim=1)
    chunk_bits = inc[:, -1]
    nw = (chunk_bits + 31) >> 5
    wstart = torch.cumsum(nw, 0) - nw
    off = (wstart[:, None] * 32 + (inc - nb)).reshape(-1)
    return off, nw, chunk_bits


def bitpack_at(values, nbits, off, num_words: int) -> torch.Tensor:
    """Fields (<= 32 bits) at absolute bit offsets -> num_words u32
    words (int64).  As in the JAX package, a carry past the end lands in
    the last word and a field starting past the end is dropped."""
    word, lo, hi = _split(values, off)
    return _place(num_words, (word, lo),
                  (torch.clamp(word + 1, max=num_words - 1), hi))


def pack_chunks_plain(values, nbits, ch: int, ow: int):
    """Plain twin of the chunk_pack kernel.  values i32 [u32 bits] and
    nbits i32, both [F] with F % ch == 0 -> (chunks i32 [u32 bits]
    [R, ow], chunk_bits i32 [R])."""
    R = nbits.shape[0] // ch
    nb = nbits.reshape(R, ch).to(torch.int64)
    inc = torch.cumsum(nb, dim=1)
    word, lo, hi = _split(values.reshape(R, ch), inc - nb)
    base = torch.arange(R, device=nb.device)[:, None] * ow
    dump = R * ow
    idx_lo = torch.where(word < ow, base + word, dump)
    idx_hi = torch.where(word + 1 < ow, base + word + 1, dump)
    words = _place(R * ow, (idx_lo, lo), (idx_hi, hi))
    return bits32(words).reshape(R, ow), inc[:, -1].to(torch.int32)


def pack_chunks(values, nbits, ch: int, ow: int):
    """Pack fields [r*ch, (r+1)*ch) LSB-first into row r of chunks
    [R, ow] (bits past ow*32 dropped, words past the chunk's bits zero)
    and return (chunks, chunk_bits).  CUDA tensors launch the kernel,
    CPU tensors take the plain twin."""
    if values.device.type == "cpu":
        return pack_chunks_plain(values, nbits, ch, ow)
    if values.device.type != "cuda":
        raise ValueError(f"pack_chunks: unsupported device {values.device}")
    F = values.shape[0]
    for t in (values, nbits):
        if (t.device != values.device or t.dtype != torch.int32
                or t.dim() != 1 or t.shape[0] != F
                or not t.is_contiguous()):
            raise ValueError(f"pack_chunks: bad input {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if ch not in (256, 512, 1024, 2048, 4096) or F % ch or not 1 <= ow <= 4096:
        raise ValueError(f"pack_chunks: unsupported ch={ch} ow={ow} F={F}")
    R = F // ch
    chunks = torch.empty((R, ow), dtype=torch.int32, device=values.device)
    chunk_bits = torch.empty(R, dtype=torch.int32, device=values.device)
    rc = _kernels.lib().hyd_chunk_pack(
        values.data_ptr(), nbits.data_ptr(), R, ch, ow, chunks.data_ptr(),
        chunk_bits.data_ptr(), _kernels.stream_ptr(values))
    _kernels.check(rc, "chunk_pack")
    pack_chunks.launches += 1
    return chunks, chunk_bits


pack_chunks.launches = 0


def overwrite_compact(chunks: torch.Tensor, nw: torch.Tensor,
                      num_words: int) -> torch.Tensor:
    """Place the first nw[r] words of each chunk row back to back at
    word cumsum(nw)[r] - nw[r]; i32 [num_words], zero past the last
    chunk (words past num_words are dropped)."""
    R, ow = chunks.shape
    nw = nw.to(torch.int64)
    wstart = torch.cumsum(nw, 0) - nw
    j = torch.arange(ow, device=chunks.device)
    dst = wstart[:, None] + j[None, :]
    keep = (j[None, :] < nw[:, None]) & (dst < num_words)
    dst = torch.where(keep, dst, num_words)
    out = torch.zeros(num_words + 1, dtype=chunks.dtype, device=chunks.device)
    out.scatter_(0, dst.reshape(-1), chunks.reshape(-1))
    return out[:num_words]


def bitpack_v3(values, nbits, ch: int, ow: int, num_words: int):
    """Format-v3 chunk stream: (words i32 [u32 bits] [num_words], nw
    int64 [R], chunk_bits i32 [R])."""
    chunks, chunk_bits = pack_chunks(values, nbits, ch, ow)
    nw = (chunk_bits.to(torch.int64) + 31) >> 5
    return overwrite_compact(chunks, nw, num_words), nw, chunk_bits


def bitpack(values, nbits, num_words: int):
    """Bit-contiguous fields (<= 32 bits) -> (u32 words int64
    [num_words], total bits int64); twin of pipeline._bitpack."""
    nb = nbits.to(torch.int64)
    off = torch.cumsum(nb, 0) - nb
    total = off[-1] + nb[-1] if nb.numel() else nb.new_zeros(())
    return bitpack_at(values, nb, off, num_words), total


def bitpack64(lo_vals, hi_vals, nbits, num_words: int):
    """bitpack for fields up to 64 bits split into (low 32, high) u32
    halves; twin of pipeline._bitpack64."""
    nb = nbits.to(torch.int64)
    off = torch.cumsum(nb, 0) - nb
    total = off[-1] + nb[-1] if nb.numel() else nb.new_zeros(())
    word = off >> 5
    s = off & 31
    inv = 32 - s
    lo, hi = u32(lo_vals), u32(hi_vals)
    c0 = (lo << s) & _MASK32
    c1 = (torch.where(s > 0, lo >> inv, 0) | (hi << s)) & _MASK32
    c2 = torch.where(s > 0, hi >> inv, 0)
    last = num_words - 1
    return _place(num_words, (word, c0), (torch.clamp(word + 1, max=last), c1),
                  (torch.clamp(word + 2, max=last), c2)), total
