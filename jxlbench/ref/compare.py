"""The comparison that decides `correct` for an encoded file.

The encoder quantizes by truncation: HF q = trunc(u) with |q| < 2 set to
0, LF q = trunc(u).  A coefficient the program wrote is sound when the
exact u (ref.front, float64) lies in the set of inputs that give that q;
its margin is how far u lies outside that set, in quantizer steps.
Float32 rounding in the program's front moves u by up to about 1e-4 of
a step and can flip a coefficient whose u sits that close to a boundary:
a margin of that size.  A TF32 front moves it by tenths of a step, and
a wrong token, block or section by a step or more (a lone +-1 HF value
has no preimage at all: infinite).

Numbers compared, each with its limit (the configuration file's "limits"):
- parse_faults: files that break the format or leave the encoder's
  subset (ref.decode), TOC and section sizes included.  Exact: 0.
- margin_max: the largest margin over every LF and HF coefficient of
  every file checked."""

from __future__ import annotations

import numpy as np


def hf_margin(u: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Margins of HF values q (zig-zag slots 1..63) against inputs u."""
    u, q = u[..., 1:, :], q[..., 1:, :].astype(np.float64)
    lo = np.where(q >= 2, q, np.where(q <= -2, q - 1, -2.0))
    hi = np.where(q >= 2, q + 1, np.where(q <= -2, q, 2.0))
    m = np.maximum(np.maximum(lo - u, u - hi), 0.0)
    return np.where(np.abs(q) == 1, np.inf, m)


def lf_margin(u: np.ndarray, q: np.ndarray) -> np.ndarray:
    q = q.astype(np.float64)
    lo = np.where(q > 0, q, np.where(q < 0, q - 1, -1.0))
    hi = np.where(q > 0, q + 1, np.where(q < 0, q, 1.0))
    return np.maximum(np.maximum(lo - u, u - hi), 0.0)


def judge(u_lf, u_hf, q_lf, q_hf) -> dict:
    """Margins and flips of one image's coefficients."""
    ml, mh = lf_margin(u_lf, q_lf), hf_margin(u_hf, q_hf)
    return {"margin_max": float(max(ml.max(), mh.max())),
            "flips": int((ml > 0).sum() + (mh > 0).sum()),
            "coefficients": int(ml.size + mh.size)}
