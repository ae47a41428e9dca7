"""The packed payload's host side: verify the device's checksums, count
the stream words to copy back, parse the aux prefix and the streams,
and feed the HF stream through the C++ walker.

The port's copy of the numpy-only payload helpers of
hydrium_tpu/encoder.py.  The layout contract is ops/packed.py's module
comment, shared with csrc/host/serializer.cc (hyd_hf_add_lfg_packed,
hyd_lf_decode).
"""

from __future__ import annotations

import numpy as np

from .jxl import native
from .ops.constants import AUX_SCALARS


def _parse_packed(aux: np.ndarray, words, buf_h: int, buf_w: int, lfg,
                  lf_lut=None):
    """Decode one packed v4 aux payload (+ fetched stream words) into
    the pieces the serializer needs; None when the ok flag is unset or
    the LF stream fails to decode.

    lf_lut: u16[4096] class-9 transport decode LUT snapshotted from the
    dispatch that packed this payload (jxl/tokcode.py LF_CLASS row);
    required when `words` is given (the LF residual stream is hybrid-
    uint transport-coded in format v4)."""
    if not bool(aux[0] & 1):
        return None
    G = (buf_h >> 8) * (buf_w >> 8)
    vbh, vbw = buf_h >> 3, buf_w >> 3
    vh, vw = (lfg.height + 7) >> 3, (lfg.width + 7) >> 3
    tok_total, res_total, lf_total = int(aux[1]), int(aux[2]), int(aux[3])
    S = AUX_SCALARS
    hist = aux[S:S + 640]        # [10, 64] per-class transport histogram
    o = S + 640
    gs = aux[o:o + G].astype(np.int64)
    gr = aux[o + G:o + 2 * G].astype(np.int64)
    gt = aux[o + 2 * G:o + 3 * G].astype(np.int64)
    lf_n = vbh * vbw * 3
    lf_used = (lf_total + 31) >> 5
    tok_used = (tok_total + 31) >> 5
    res_used = (res_total + 31) >> 5
    out = {
        "hist": hist, "gs": gs, "gr": gr,
        "tok_off": np.cumsum(gt) - gt, "res_off": np.cumsum(gr) - gr,
        "need_words": lf_used + tok_used + res_used,
        "lf_res": None, "tok_words": None, "res_words": None,
    }
    if words is not None:
        lf_flat = native.lf_decode(words, lf_lut, lf_n, lf_total)
        if lf_flat is None:
            return None
        out["lf_res"] = lf_flat.reshape(vbh, vbw, 3)[:vh, :vw]
        out["tok_words"] = words[lf_used:lf_used + tok_used + 1]
        out["res_words"] = np.ascontiguousarray(
            words[lf_used + tok_used:])
    return out


def packed_need_words(aux: np.ndarray) -> int:
    """Stream word count (past the aux prefix) for a v4 aux payload."""
    return (((int(aux[3]) + 31) >> 5) + ((int(aux[1]) + 31) >> 5)
            + ((int(aux[2]) + 31) >> 5))


def packed_verify(aux: np.ndarray, words) -> bool:
    """Check the device-computed wrap-sum checksums of a v4 payload: the
    aux tail always, and the three stream sections when `words` (the
    region past the aux prefix) is given."""
    u = aux.view(np.uint32)
    if int(np.sum(u[8:], dtype=np.uint32)) != int(u[4]):
        return False
    if words is None or not bool(aux[0] & 1):
        return True
    wu = words.view(np.uint32)
    lf_used = (int(aux[3]) + 31) >> 5
    tok_used = (int(aux[1]) + 31) >> 5
    res_used = (int(aux[2]) + 31) >> 5
    if int(np.sum(wu[:lf_used], dtype=np.uint32)) != int(u[5]):
        return False
    if int(np.sum(wu[lf_used:lf_used + tok_used],
                  dtype=np.uint32)) != int(u[6]):
        return False
    if int(np.sum(wu[lf_used + tok_used:lf_used + tok_used + res_used],
                  dtype=np.uint32)) != int(u[7]):
        return False
    return True


def _feed_hf_packed(hf, parsed, lfg, buf_w: int, buf_h: int, preset: int,
                    tok_lut) -> None:
    """Feed a parsed packed payload into an HF stream (bulk-threaded C++
    walk; the walker handles partial grids itself)."""
    hf.add_lfg_packed(parsed["tok_words"], parsed["res_words"], tok_lut,
                      preset, (buf_h >> 8, buf_w >> 8),
                      (lfg.varblock_height, lfg.varblock_width),
                      parsed["tok_off"], parsed["res_off"], parsed["gs"])
