"""Payload-format and front constants of the packed encode path.

Port-owned copies of the constants in hydrium_tpu/ops/pipeline.py.
They are format semantics shared with the host walker
(csrc/host/serializer.cc) and host._parse_packed, so
tests/test_torch_front.py pins every one of them equal to the JAX
package's value.
"""

from __future__ import annotations

import os

import numpy as np

from . import tables

# emission channel order Y, X, B -> storage index (internal.h order)
EMIT_TO_STORE = np.array([1, 0, 2], dtype=np.int32)

# fused zig-zag + channel gather: emission (channel c, zig-zag j) ->
# flat offset into the [8(ky), 8(kx), 3] coefficient block
ZZ_GATHER = (tables.ZIGZAG_KY[None, :] * 24 + tables.ZIGZAG_KX[None, :] * 3
             + EMIT_TO_STORE[:, None]).reshape(-1)            # [192]

# HF quant weights in emission order [3, 64]
HF_W_EMIT = tables.HF_QUANT_WEIGHTS[EMIT_TO_STORE].astype(np.float32)
# ...premultiplied by HF_MULT, as the fused front applies them
HF_W_SCALED = HF_W_EMIT * np.float32(tables.HF_MULT)
# zig-zag position j -> ky * 8 + kx
ZZ_POS = (tables.ZIGZAG_KY * 8 + tables.ZIGZAG_KX).astype(np.int32)

# DCT-II basis with the reference's rounded constants: row 0 is the DC
# mean row (0.125), rows 1..7 the cosine rows
DCT_BASIS = np.concatenate(
    [np.full((1, 8), 0.125, np.float32), tables.COSINE_LUT], axis=0)

# transport-histogram block sampling (same env var and default as the
# JAX package, read at import there too; both must agree for the aux
# histogram words to match)
HIST_SAMPLE_STRIDE = max(1, int(os.environ.get(
    "HYDRIUM_HIST_SAMPLE_STRIDE", "4")))

# format-v3 chunk geometry: fields per chunk and chunk buffer words
TOK_CHUNK, TOK_OW = 4096, 1552
TOK_MAX_LEN = 12                 # jxl/tokcode.py MAX_LEN
RES_CHUNK, RES_OW_FAST, RES_OW_WIDE = 2048, 784, 1552
# per-field residue caps and the per-chunk slack words the ok
# thresholds leave (format semantics: the ok word must not depend on
# the backend)
RES_CAP_FAST, RES_LANES_FAST = 15, 2
RES_CAP_WIDE, RES_LANES_WIDE = 30, 4

# aux layout (format v4): 8 scalars, 10 x 64 histogram words, 3*G
# per-group words
AUX_SCALARS = 8
AUX_HIST_ROWS = 10


def packed_aux_len(buf_h: int, buf_w: int) -> int:
    """Length in 32-bit words of the aux prefix of a combined payload."""
    G = (buf_h >> 8) * (buf_w >> 8)
    return AUX_SCALARS + AUX_HIST_ROWS * 64 + 3 * G
