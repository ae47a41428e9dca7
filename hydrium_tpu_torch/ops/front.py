"""The front of the packed path: pixels of one LF group -> integer
tokens.  Twin of hydrium_tpu/ops/pipeline.py encode_lfg (its plain-XLA
branch; the opt-in Pallas frontend is not ported).

Integer conventions.  CPU torch has no uint32 arithmetic, so every
unsigned 32-bit quantity is computed in int64 and STORED as int32 with
the same bit pattern (`bits32`); u16 tokens are stored as int16 the
same way (`bits16`).  `u32` turns a stored pattern back into its
unsigned value.  The storage widths are the ones the transport kernel
reads (tokens u16, clusters u8, residues u32, residue bits u8).

Float parity with the JAX package is close but not exact: torch has no
cbrt (pow(x, 1/3) differs from XLA's cbrt by one ulp on ~1% of XYB
values) and the DCT product sums in another order.  A few coefficients
per million land on the other side of a truncation; the tests bound
that flip rate and compare everything downstream of the integers
exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from hydrium_tpu.ops import tables

from . import constants as C

_MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """Stored 32-bit pattern (any int dtype) -> unsigned value, int64."""
    return x.to(torch.int64) & _MASK32


def bits32(x: torch.Tensor) -> torch.Tensor:
    """int64 values (taken mod 2^32) -> int32 with the same bits."""
    x = x & _MASK32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def bits16(x: torch.Tensor) -> torch.Tensor:
    """int64 values (taken mod 2^16) -> int16 with the same bits."""
    x = x & 0xFFFF
    return torch.where(x >= 1 << 15, x - (1 << 16), x).to(torch.int16)


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 truncating toward zero, saturating like XLA's
    convert (out-of-range values clamp to the int32 range, NaN -> 0);
    a plain torch cast leaves out-of-range values undefined."""
    i = x.nan_to_num(0.0).clamp(-2.0 ** 31, 2147483520.0).to(torch.int32)
    return torch.where(x >= 2.0 ** 31, torch.iinfo(torch.int32).max, i)


class FrontEnd(torch.nn.Module):
    """The front's constant tables as buffers (the system has no
    weights; these tables and the transport code tables are its state).
    forward() runs the float part: sample scaling, XYB, the 8x8 DCT and
    LF/HF quantization."""

    def __init__(self, dct_basis, hf_w_emit, lf_shift, zz_gather,
                 cnzc3, cfc3) -> None:
        super().__init__()
        self.register_buffer("dct_basis", dct_basis)   # [8, 8] f32
        self.register_buffer("hf_w_emit", hf_w_emit)   # [3, 64] f32
        self.register_buffer("lf_shift", lf_shift)     # [3] f32
        self.register_buffer("zz_gather", zz_gather)   # [192] i64
        self.register_buffer("cnzc3", cnzc3)           # [64] i64
        self.register_buffer("cfc3", cfc3)             # [63] i64

    @classmethod
    def from_tables(cls) -> "FrontEnd":
        """Carry the JAX package's numpy tables over as the port's."""
        t = torch.as_tensor
        return cls(
            dct_basis=t(C.DCT_BASIS, dtype=torch.float32),
            hf_w_emit=t(C.HF_W_EMIT, dtype=torch.float32),
            lf_shift=t(tables.LF_SHIFT, dtype=torch.float32),
            zz_gather=t(C.ZZ_GATHER.astype(np.int64)),
            cnzc3=t(np.asarray(tables.COEFF_NUM_NONZERO_CONTEXT,
                               np.int64) % 3),
            cfc3=t(np.asarray(tables.COEFF_FREQ_CONTEXT[1:], np.int64) % 3))

    def forward(self, pixels: torch.Tensor, height: int, width: int, *,
                buf_h: int, buf_w: int, linear_light: bool,
                sample_kind: str):
        """pixels [uh <= buf_h, uw <= buf_w, 3] -> (q_flat i32 [N, 64] in
        emission order, lf_q i32 [buf_h/8, buf_w/8, 3])."""
        uh, uw = pixels.shape[0], pixels.shape[1]
        rgb = pixels.to(torch.float32)
        if uh != buf_h or uw != buf_w:
            rgb = F.pad(rgb, (0, 0, 0, buf_w - uw, 0, buf_h - uh))
        vbh, vbw = buf_h >> 3, buf_w >> 3
        if sample_kind == "uint8":
            rgb = rgb * float(np.float32(1.0 / 255.0))
        elif sample_kind == "uint16":
            rgb = rgb * float(np.float32(1.0 / 65535.0))
        xyb = rgb_to_xyb(rgb, linear_light)
        dev = xyb.device
        row_ok = torch.arange(buf_h, device=dev)[:, None, None] < height
        col_ok = torch.arange(buf_w, device=dev)[None, :, None] < width
        xyb = torch.where(row_ok & col_ok, xyb, 0.0)

        coeffs = forward_dct(xyb, self.dct_basis)    # [vbh, vbw, 8, 8, 3]
        lf_q = f32_to_i32(coeffs[:, :, 0, 0, :] * self.lf_shift)
        zz = coeffs.reshape(vbh, vbw, 192)[:, :, self.zz_gather]
        zz = zz.reshape(vbh, vbw, 3, 64)
        q = f32_to_i32((zz * self.hf_w_emit) * float(tables.HF_MULT))
        q = torch.where(q.abs() < 2, 0, q)
        q[..., 0] = 0
        return group_flat(q, buf_h, buf_w), lf_q


def group_flat(x: torch.Tensor, buf_h: int, buf_w: int) -> torch.Tensor:
    """[vbh, vbw, 3, 64] varblock grid -> [N, 64] flat group order
    (group raster, block raster within the group, channel)."""
    gcy, gcx = buf_h >> 8, buf_w >> 8
    g = x.reshape((gcy, 32, gcx, 32) + tuple(x.shape[2:]))
    perm = (0, 2, 1, 3) + tuple(range(4, g.dim()))
    return g.permute(perm).reshape((gcy * gcx * 1024 * 3,)
                                   + tuple(x.shape[3:]))


def _linearize(x: torch.Tensor) -> torch.Tensor:
    """sRGB EOTF cubic approximation (format.c:15-19)."""
    lo = 0.07739938080495357 * x
    hi = 0.003094300919832 + x * (
        -0.009982599 + x * (0.72007737769 + 0.2852804880 * x))
    return torch.where(x <= 0.0404482362771082, lo, hi)


def _bias_cbrt(x: torch.Tensor) -> torch.Tensor:
    """cbrt(x + bias) - 0.155954 (format.c:29-31); torch has no cbrt,
    so the cube root is a signed pow."""
    y = x + 0.0037930732552754493
    return torch.sign(y) * y.abs().pow(1.0 / 3.0) - 0.155954


def rgb_to_xyb(rgb: torch.Tensor, linear_light: bool) -> torch.Tensor:
    """[..., 3] float32 RGB in 0..1 -> XYB (format.c:38-46)."""
    if not linear_light:
        rgb = _linearize(rgb)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    lgamma = _bias_cbrt(0.3 * r + 0.622 * g + 0.078 * b)
    mgamma = _bias_cbrt(0.23 * r + 0.692 * g + 0.078 * b)
    sgamma = _bias_cbrt(0.243423 * r + 0.204767 * g + 0.55181 * b)
    y = (lgamma + mgamma) * 0.5
    x = y - mgamma
    bb = sgamma - y
    return torch.stack([x, y, bb], dim=-1)


def forward_dct(xyb: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """[vh*8, vw*8, 3] -> [vh, vw, 8(ky), 8(kx), 3]: two float32
    products against the rounded basis (TF32 off, see device.py)."""
    h, w, c = xyb.shape
    vh, vw = h // 8, w // 8
    blocks = xyb.reshape(vh, 8, vw, 8, c).permute(0, 2, 1, 3, 4)
    t = torch.einsum("abyxc,kx->abykc", blocks, basis)
    return torch.einsum("abykc,my->abmkc", t, basis)


def pack_signed(v: torch.Tensor) -> torch.Tensor:
    """Signed ints -> zig-zag unsigned values (int64, mod 2^32 like the
    JAX package's int32 shift then uint32 cast)."""
    v = v.to(torch.int64)
    return torch.where(v >= 0, v << 1, ((-v) << 1) - 1) & _MASK32


def lf_residuals(lf_q: torch.Tensor, seg_vb: int = 0) -> torch.Tensor:
    """Clamped-gradient prediction residuals (encoder.c:583-591),
    [vh, vw, 3] int32 -> int64 pack_signed values.  seg_vb > 0 restarts
    prediction every seg_vb varblock rows."""
    v = lf_q.to(torch.int64)
    left = F.pad(v[:, :-1], (0, 0, 1, 0))
    up = F.pad(v[:-1], (0, 0, 0, 0, 1, 0))
    upleft = F.pad(v[:-1, :-1], (0, 0, 1, 0, 1, 0))
    vh, vw, _ = v.shape
    rows = torch.arange(vh, device=v.device)
    if seg_vb > 0:
        rows = rows % seg_vb
    has_x = torch.arange(vw, device=v.device)[None, :, None] > 0
    has_y = rows[:, None, None] > 0
    w = torch.where(has_x, left, torch.where(has_y, up, 0))
    n = torch.where(has_y, up, w)
    nw = torch.where(has_x & has_y, upleft, w)
    pred = torch.minimum(torch.maximum(w + n - nw, torch.minimum(w, n)),
                         torch.maximum(w, n))
    return pack_signed(v - pred)


def _fllog2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for int64 1 <= x < 2^32, exact (binary search on
    shifts: torch has no count-leading-zeros)."""
    e = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        e = e + s * ((x >> (e + s)) > 0)
    return e


def hybridize(values: torch.Tensor):
    """Vectorized hybrid-uint, config (4,1,0) (entropy.c:427-444).
    values: int64 in [0, 2^32).  Returns int64 (token [u16 range],
    residue, residue_bits), with the JAX package's int32 view of the
    value (so values >= 2^31 behave as it does)."""
    v = torch.where(values >= 1 << 31, values - (1 << 32), values)
    small = v < 16
    x = torch.clamp(v, min=16)
    n = _fllog2(x) - 1
    residue_bits = torch.where(small, 0, n)
    residue = torch.where(small, 0, x & ((1 << n) - 1))
    high = (x >> n) & 1
    token = torch.where(small, v, 16 + (high | ((n - 3) << 1))) & 0xFFFF
    return token, residue, residue_bits


def tokenize_flat(q: torch.Tensor, nz_flat: torch.Tensor,
                  preset_flat: torch.Tensor, blockctx_flat: torch.Tensor,
                  clusters_per_preset: int, front: FrontEnd):
    """HF context modeling + tokenization on the flat layout (twin of
    pipeline.tokenize_flat, with its analytic 9/3/2/1 cluster rules).

    q [N, 64] int32 (slot 0 unused), nz_flat/preset_flat/blockctx_flat
    [N].  Returns (tokens i16 [u16 bits], clusters u8, residues i32
    [u32 bits], residue_bits u8, valid_len i32 [N])."""
    nonzero = (q[:, 1:] != 0).to(torch.int64)
    cum = torch.cumsum(nonzero, dim=-1)
    nz = nz_flat.to(torch.int64)
    remaining = nz[:, None] - F.pad(cum[:, :-1], (1, 0))
    prev = torch.cat([(nz <= 4).to(torch.int64)[:, None], nonzero[:, :-1]],
                     dim=-1)
    bctx = blockctx_flat.to(torch.int64)
    per = clusters_per_preset
    if per == 9:
        m3 = front.cnzc3[remaining.clamp(0, 63)]
        m = (bctx[:, None] + m3 + front.cfc3[None, :]) % 3
        cls_coeff = 3 + 2 * m + prev
        cls0 = bctx
    elif per == 3:
        cls_coeff = 1 + prev
        cls0 = torch.zeros_like(bctx)
    elif per == 2:
        cls_coeff = torch.ones_like(prev)
        cls0 = torch.zeros_like(bctx)
    else:
        cls_coeff = torch.zeros_like(prev)
        cls0 = torch.zeros_like(bctx)
    clusters = ((per * preset_flat.to(torch.int64)[:, None]
                 + torch.cat([cls0[:, None], cls_coeff], dim=-1))
                & 0xFF).to(torch.uint8)

    j_idx = torch.arange(1, 64, device=q.device)
    last_nz = torch.where(nonzero > 0, j_idx[None, :], 0).amax(dim=-1)
    valid_len = (1 + last_nz).to(torch.int32)

    values = torch.cat([nz[:, None] & _MASK32, pack_signed(q[:, 1:])], dim=-1)
    tokens, residues, residue_bits = hybridize(values)
    return (bits16(tokens), clusters, bits32(residues),
            residue_bits.to(torch.uint8), valid_len)


def front_tokens(front: FrontEnd, pixels: torch.Tensor, height: int,
                 width: int, presets: torch.Tensor, *, buf_h: int,
                 buf_w: int, linear_light: bool, sample_kind: str,
                 clusters_per_preset: int,
                 lf_seg_vb: int = 0) -> Dict[str, torch.Tensor]:
    """Pixels of one LF group -> the integer front outputs the packed
    tail consumes (encode_lfg without the cluster histogram).  presets:
    [G] preset per buffer group.  Keys: lf_q, lf_res (i32 u32-bits),
    tokens, clusters, residues, residue_bits, valid_len."""
    q_flat, lf_q = front(pixels, height, width, buf_h=buf_h, buf_w=buf_w,
                         linear_light=linear_light, sample_kind=sample_kind)
    dev = q_flat.device
    gcy, gcx = buf_h >> 8, buf_w >> 8
    G = gcy * gcx
    nz_flat = (q_flat != 0).sum(dim=-1)
    preset_flat = presets.to(dev).repeat_interleave(1024 * 3)
    blockctx_flat = torch.arange(3, device=dev).repeat(G * 1024)
    tokens, clusters, residues, residue_bits, valid_len = tokenize_flat(
        q_flat, nz_flat, preset_flat, blockctx_flat, clusters_per_preset,
        front)

    # blocks beyond each group's true varblock extent emit nothing
    vh, vw = (height + 7) >> 3, (width + 7) >> 3
    gbh = (vh - torch.arange(gcy, device=dev) * 32).clamp(0, 32)
    gbw = (vw - torch.arange(gcx, device=dev) * 32).clamp(0, 32)
    by = torch.arange(32, device=dev)
    ok = ((by[None, :, None, None] < gbh[:, None, None, None])
          & (by[None, None, None, :] < gbw[None, None, :, None]))
    ok = ok.permute(0, 2, 1, 3).reshape(-1).repeat_interleave(3)
    valid_len = torch.where(ok, valid_len, 0)

    return {"lf_q": lf_q, "lf_res": bits32(lf_residuals(lf_q, lf_seg_vb)),
            "tokens": tokens, "clusters": clusters, "residues": residues,
            "residue_bits": residue_bits, "valid_len": valid_len}


def cluster_histogram(out: Dict[str, torch.Tensor],
                      num_clusters: int) -> torch.Tensor:
    """Per-cluster token histogram [num_clusters, 128] over valid slots
    (tokens clipped to 127), the `hist` output of encode_lfg."""
    tokens = out["tokens"].to(torch.int64) & 0xFFFF
    valid_len = out["valid_len"]
    dev = tokens.device
    mask = (torch.arange(64, device=dev)[None, :]
            < valid_len[:, None]).to(torch.int32)
    hist = torch.zeros((num_clusters, 128), dtype=torch.int32, device=dev)
    hist.index_put_((out["clusters"].to(torch.int64),
                     tokens.clamp(max=127)), mask, accumulate=True)
    return hist


def encode_lfg(front: FrontEnd, pixels: torch.Tensor, height: int,
               width: int, presets: torch.Tensor, *, buf_h: int, buf_w: int,
               linear_light: bool, num_clusters: int, sample_kind: str,
               lf_seg_vb: int = 0,
               clusters_per_preset: int = 0) -> Dict[str, torch.Tensor]:
    """Twin of pipeline.encode_lfg: front_tokens plus the per-cluster
    histogram.  The unpacked fallback path runs it."""
    out = front_tokens(
        front, pixels, height, width, presets, buf_h=buf_h, buf_w=buf_w,
        linear_light=linear_light, sample_kind=sample_kind,
        clusters_per_preset=clusters_per_preset or num_clusters,
        lf_seg_vb=lf_seg_vb)
    out["hist"] = cluster_histogram(out, num_clusters)
    return out
