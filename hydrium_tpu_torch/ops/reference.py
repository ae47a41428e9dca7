"""The two numpy helpers of the reference pipeline that the frame
serializer needs (the port's copy, from hydrium_tpu/ops/reference.py):
LF clamped-gradient residuals and the zig-zag signed map."""

from __future__ import annotations

import numpy as np


def lf_predict_residuals(lf_q: np.ndarray) -> np.ndarray:
    """Clamped-gradient prediction residuals (encoder.c:583-591).

    lf_q: [vh, vw, 3] int32 -> residuals [vh, vw, 3] int32 (value - pred)."""
    v = lf_q.astype(np.int64)
    left = np.empty_like(v)
    left[:, 1:] = v[:, :-1]
    left[:, 0] = 0
    up = np.empty_like(v)
    up[1:] = v[:-1]
    up[0] = 0
    upleft = np.empty_like(v)
    upleft[1:, 1:] = v[:-1, :-1]
    upleft[0] = 0
    upleft[:, 0] = 0

    has_x = np.zeros(v.shape, dtype=bool)
    has_x[:, 1:] = True
    has_y = np.zeros(v.shape, dtype=bool)
    has_y[1:] = True

    w = np.where(has_x, left, np.where(has_y, up, 0))
    n = np.where(has_y, up, w)
    nw = np.where(has_x & has_y, upleft, w)
    vp = w + n - nw
    vmin = np.minimum(w, n)
    vmax = np.maximum(w, n)
    pred = np.clip(vp, vmin, vmax)
    return (v - pred).astype(np.int32)


def pack_signed(v: np.ndarray) -> np.ndarray:
    """Zig-zag signed->unsigned map (math-functions.h:69-72)."""
    v = v.astype(np.int64)
    return np.where(v >= 0, v << 1, (-v << 1) - 1).astype(np.uint32)
