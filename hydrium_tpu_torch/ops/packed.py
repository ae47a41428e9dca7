"""The packed payload (format v4) of one LF group: twin of the tail of
hydrium_tpu/ops/pipeline.py encode_lfg_packed.

Layout (u32 words; the layout comment in pipeline.py is the contract,
shared with host._parse_packed and csrc/host/serializer.cc):

    aux   [0] ok word (1 valid, 2 retry with wide_residues, 0 fall back
              to the unpacked path)  [1] token bits  [2] residue bits
          [3] LF bits  [4..7] wrap-sum checksums of aux[8:], LF, token
              and residue words
          [8:648] per-class transport histogram (9 HF classes + LF)
          then per-group symbol counts, residue bits, token bits (G each)
    then LF words | token words | residue words at dynamic offsets, in
    one buffer of A + lf_cap + tok_cap + res_cap words.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import front as _front
from .bitpack import bitpack, bitpack64, compact_chunks, pack_chunk_streams
from .constants import (RES_CAP_FAST, RES_CAP_WIDE, RES_CHUNK,
                        RES_LANES_FAST, RES_LANES_WIDE, RES_OW_FAST,
                        RES_OW_WIDE, TOK_CHUNK, TOK_MAX_LEN, TOK_OW)
from .front import _MASK32, bits32, hybridize, u32
from .transport import hf_transport_streams


def lf_histogram(lf_t: torch.Tensor) -> torch.Tensor:
    """Counts of the LF tokens lf_t (int64, already clamped to 63) in 64
    fixed bins: bincount(lf_t, minlength=64) without the device read of
    the maximum that sizes bincount's output."""
    hist = torch.zeros(64, dtype=torch.int64, device=lf_t.device)
    return hist.scatter_add_(0, lf_t, torch.ones_like(lf_t))


def _lf_pack_stream(lf_res: torch.Tensor, tok_len, tok_code,
                    wide_residues: bool):
    """The format-v4 LF residual stream: per value one field = transport
    code of its hybrid-uint token (class 9) then the raw residue bits.
    Returns (lf_words i64 u32 values, lf_total, hist_lf [64], lf_tok_ok,
    lf_fit_fast, lf_fit_wide, lf_cap_words)."""
    vals = u32(lf_res.reshape(-1))
    lf_n = vals.shape[0]
    lf_tok, lf_residue, lf_rbits = hybridize(vals)
    lf_tok_ok = torch.all(lf_tok < 64)
    lf_t = lf_tok.clamp(max=63)
    lf_code = tok_code.to(torch.int64)[9 * 64 + lf_t]
    lf_len = tok_len.to(torch.int64)[9 * 64 + lf_t]
    hist_lf = lf_histogram(lf_t)
    lf_nbits = lf_len + lf_rbits
    lf_lo = (lf_code | (lf_residue << lf_len)) & _MASK32
    lf_fit_fast = torch.all(lf_nbits <= 32)
    lf_fit_wide = torch.all(lf_rbits <= 30)    # len <= 12 -> field <= 42
    lf_cap_words = lf_n + lf_n // 2            # 42 bits/value worst case
    if wide_residues:
        lf_hi = torch.where(lf_len > 0, lf_residue >> (32 - lf_len), 0)
        lf_words, lf_total = bitpack64(lf_lo, lf_hi, lf_nbits, lf_cap_words)
    else:
        lf_words, lf_total = bitpack(
            lf_lo, torch.where(lf_nbits <= 32, lf_nbits, 0), lf_cap_words)
    return (lf_words, lf_total, hist_lf, lf_tok_ok, lf_fit_fast,
            lf_fit_wide, lf_cap_words)


def _wrap_sum(words: torch.Tensor) -> torch.Tensor:
    return u32(words).sum() & _MASK32


def _place_at(buf: torch.Tensor, x: torch.Tensor, start) -> None:
    """buf[start:start+len(x)] = x for a device-scalar start, clamped
    like a dynamic_update_slice (no host round trip)."""
    n = x.shape[0]
    s = torch.clamp(start, 0, buf.shape[0] - n)
    buf.index_copy_(0, s + torch.arange(n, device=buf.device), x)


def pack_payload(out: Dict[str, torch.Tensor], tok_len: torch.Tensor,
                 tok_code: torch.Tensor, *, tok_classes: int,
                 wide_residues: bool) -> torch.Tensor:
    """Front outputs (front_tokens' keys) + the transport code tables
    (i32 [10*64], on the same device) -> the combined payload, i32 [u32
    bits] [A + lf_cap + tok_cap + res_cap]."""
    valid_len = out["valid_len"]
    N = valid_len.shape[0]
    G = N // (1024 * 3)
    M = N * 64
    dev = valid_len.device

    t_flat, t_bits, hist64, r_flat, r_bits, tok_ok = hf_transport_streams(
        out, tok_len, tok_code, tok_classes)

    res_ow = RES_OW_WIDE if wide_residues else RES_OW_FAST
    res_cap = RES_CAP_WIDE if wide_residues else RES_CAP_FAST
    res_lanes = RES_LANES_WIDE if wide_residues else RES_LANES_FAST
    tok_cap_words = (M // TOK_CHUNK) * ((TOK_MAX_LEN * TOK_CHUNK) >> 5)
    res_cap_words = (M // RES_CHUNK) * (res_ow - res_lanes)
    tok_chunks, res_chunks = pack_chunk_streams(
        (t_flat, t_bits, TOK_CHUNK, TOK_OW),
        (r_flat, r_bits, RES_CHUNK, res_ow))
    tok_words, tok_nw, _ = compact_chunks(*tok_chunks, tok_cap_words)
    res_words, res_nw, res_cb = compact_chunks(*res_chunks, res_cap_words)
    tok_total = 32 * tok_nw.sum()
    res_total = 32 * res_nw.sum()
    res_cb = res_cb.to(torch.int64)
    res_okc = (torch.all(res_cb <= (res_ow - res_lanes) * 32)
               & torch.all(r_bits <= res_cap))

    per_group_syms = valid_len.to(torch.int64).reshape(G, -1).sum(1)
    per_group_rbits = 32 * res_nw.reshape(G, -1).sum(1)
    per_group_tbits = 32 * tok_nw.reshape(G, -1).sum(1)

    (lf_words, lf_total, hist_lf, lf_tok_ok, lf_fit_fast, lf_fit_wide,
     lf_cap_words) = _lf_pack_stream(out["lf_res"], tok_len, tok_code,
                                     wide_residues)

    lf_ok = lf_tok_ok & (lf_fit_wide if wide_residues else lf_fit_fast)
    ok_full = tok_ok & res_okc & lf_ok
    if wide_residues:
        retryable = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        retryable = (tok_ok & lf_tok_ok & lf_fit_wide
                     & torch.all(res_cb <= (RES_OW_WIDE - RES_LANES_WIDE)
                                 * 32)
                     & ~(res_okc & lf_fit_fast))
    ok_word = torch.where(ok_full, 1, torch.where(retryable, 2, 0))

    tail = torch.cat([hist64, hist_lf, per_group_syms, per_group_rbits,
                      per_group_tbits]).to(torch.int64)
    aux = torch.cat([
        torch.stack([ok_word, tok_total, res_total, lf_total,
                     _wrap_sum(tail), _wrap_sum(lf_words),
                     _wrap_sum(tok_words), _wrap_sum(res_words)]),
        tail & _MASK32,
    ])
    A = aux.shape[0]
    lf_used = (lf_total + 31) >> 5
    tok_used = (tok_total + 31) >> 5
    combined = torch.zeros(A + lf_cap_words + tok_cap_words + res_cap_words,
                           dtype=torch.int32, device=dev)
    combined[:A] = bits32(aux)
    combined[A:A + lf_cap_words] = bits32(lf_words)
    _place_at(combined, tok_words, A + lf_used)
    _place_at(combined, res_words, A + lf_used + tok_used)
    return combined


def encode_lfg_packed(front: _front.FrontEnd, pixels: torch.Tensor,
                      height: int, width: int, presets: torch.Tensor,
                      tok_len: torch.Tensor, tok_code: torch.Tensor, *,
                      buf_h: int, buf_w: int, linear_light: bool,
                      sample_kind: str, lf_seg_vb: int = 0,
                      tok_classes: int = 9, wide_residues: bool = False,
                      fused: bool = False) -> torch.Tensor:
    """Twin of pipeline.encode_lfg_packed: pixels of one LF group ->
    its combined packed payload (see pack_payload).  fused selects the
    fused front (ops/frontend.py)."""
    out = _front.front_tokens(
        front, pixels, height, width, presets, buf_h=buf_h, buf_w=buf_w,
        linear_light=linear_light, sample_kind=sample_kind,
        clusters_per_preset=tok_classes, lf_seg_vb=lf_seg_vb, fused=fused)
    return pack_payload(out, tok_len, tok_code, tok_classes=tok_classes,
                        wide_residues=wide_residues)
