"""The fused front: pixels of an LF-group buffer -> quantized HF
coefficients and LF ints in one pass, or straight to the tokenizer's
streams.  Twin of hydrium_tpu/ops/pallas/frontend.py.

The CUDA kernel csrc/frontend.cu replaces the TPU kernel
ops/pallas/frontend.py::frontend_groups, with two epilogues:
- q/dc: frontend_lfg runs it over an LF-group buffer; frontend_groups
  keeps the JAX function's signature and layout (the same kernel over a
  [G*256, 256, 3] buffer).  Plain twin: frontend_lfg_plain.
- tokens: frontend_tokens gives, in place of q, the five streams that
  front.tokenize_lfg makes of it (the encode path's fused front).  Plain
  twin: frontend_tokens_plain (frontend_lfg_plain, then tokenize_lfg).
On a CPU tensor each wrapper takes its plain twin; on a CUDA tensor it
launches the kernel or raises.

What the fused front computes differs from FrontEnd's unfused branch
(the twin of encode_lfg's XLA branch) in three places, as the Pallas
kernel does:
1. the true-extent mask zeroes pixels before XYB, where the unfused
   branch zeroes XYB after;
2. the HF weight comes premultiplied by HF_MULT: one multiply, one
   rounding, where the unfused branch does two;
3. the cube root is cbrtf in the kernel and the signed pow of
   front._bias_cbrt in the plain twin.  The Pallas kernel's exp(log/3)
   is a third form; none of them is the bit reference.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from . import _kernels
from . import constants as C
from . import front as _front
from . import tables

_SCALE = {"uint8": float(np.float32(1.0 / 255.0)),
          "uint16": float(np.float32(1.0 / 65535.0)),
          "float32": 1.0}
_KIND = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
_TABLES: dict = {}


def default_fused() -> bool:
    """Whether the fused front is on: HYDRIUM_PALLAS=1, read as
    hydrium_tpu.ops.pipeline.default_use_pallas reads it (off by
    default)."""
    return os.environ.get("HYDRIUM_PALLAS") == "1"


def _tables(dev: torch.device) -> SimpleNamespace:
    """The fused front's constant tables on `dev` (built once)."""
    tab = _TABLES.get(dev)
    if tab is None:
        f32 = dict(dtype=torch.float32, device=dev)
        basis = torch.as_tensor(C.DCT_BASIS, **f32)
        w_scaled = torch.as_tensor(C.HF_W_SCALED, **f32)
        lf_shift = torch.as_tensor(tables.LF_SHIFT, **f32)
        cnzc3 = np.asarray(tables.COEFF_NUM_NONZERO_CONTEXT, np.int64) % 3
        cfc3 = np.asarray(tables.COEFF_FREQ_CONTEXT[1:], np.int64) % 3
        izz = np.empty(64, np.int64)
        izz[C.ZZ_POS] = np.arange(64)
        tab = _TABLES[dev] = SimpleNamespace(
            basis=basis, w_scaled=w_scaled, lf_shift=lf_shift,
            zz_gather=torch.as_tensor(C.ZZ_GATHER.astype(np.int64),
                                      device=dev),
            cnzc3=torch.as_tensor(cnzc3, device=dev),
            cfc3=torch.as_tensor(cfc3, device=dev),
            # the kernel's view: basis | weights | LF shifts, and ky*8+kx
            # -> zig-zag slot | cnzc3 | cfc3
            ftab=torch.cat([basis.reshape(-1), w_scaled.reshape(-1),
                            lf_shift]),
            itab=torch.as_tensor(np.concatenate([izz, cnzc3, cfc3]).astype(
                np.int32), device=dev))
    return tab


def frontend_lfg_plain(pixels: torch.Tensor, height: int, width: int, *,
                       buf_h: int, buf_w: int, linear_light: bool,
                       sample_kind: str):
    """Plain twin of the frontend kernel.  pixels [uh <= buf_h, uw <=
    buf_w, 3] -> (q_flat i32 [N, 64] in emission order, lf_q i32
    [buf_h/8, buf_w/8, 3])."""
    tab = _tables(pixels.device)
    uh, uw = pixels.shape[0], pixels.shape[1]
    dev = pixels.device
    keep = ((torch.arange(uh, device=dev)[:, None, None] < height)
            & (torch.arange(uw, device=dev)[None, :, None] < width))
    rgb = torch.where(keep, pixels.to(torch.float32), 0.0)
    if uh != buf_h or uw != buf_w:
        rgb = F.pad(rgb, (0, 0, 0, buf_w - uw, 0, buf_h - uh))
    if sample_kind != "float32":
        rgb = rgb * _SCALE[sample_kind]
    xyb = _front.rgb_to_xyb(rgb, linear_light)
    coeffs = _front.forward_dct(xyb, tab.basis)   # [vbh, vbw, 8, 8, 3]
    vbh, vbw = buf_h >> 3, buf_w >> 3
    lf_q = _front.f32_to_i32(coeffs[:, :, 0, 0, :] * tab.lf_shift)
    zz = coeffs.reshape(vbh, vbw, 192)[:, :, tab.zz_gather]
    q = _front.f32_to_i32(zz.reshape(vbh, vbw, 3, 64) * tab.w_scaled)
    q = torch.where(q.abs() < 2, 0, q)
    q[..., 0] = 0
    return _front.group_flat(q, buf_h, buf_w), lf_q


def _checked(pixels: torch.Tensor, buf_h: int, buf_w: int,
             sample_kind: str) -> torch.Tensor:
    """The kernel's input rules; returns the pixels as it reads them."""
    if pixels.device.type != "cuda":
        raise ValueError(f"frontend: unsupported device {pixels.device}")
    if pixels.dtype not in _KIND:
        pixels = pixels.to(torch.float32)
    if (pixels.dim() != 3 or pixels.shape[2] != 3
            or not pixels.is_contiguous() or buf_h % 256 or buf_w % 256
            or buf_h <= 0 or buf_w <= 0 or pixels.shape[0] > buf_h
            or pixels.shape[1] > buf_w or sample_kind not in _SCALE):
        raise ValueError(f"frontend: bad input {pixels.dtype} "
                         f"{tuple(pixels.shape)} for a {buf_h}x{buf_w} "
                         f"buffer of {sample_kind}; want [uh, uw, 3] "
                         "contiguous within 256-multiple buffers")
    return pixels


def _launch(pixels: torch.Tensor, height: int, width: int, buf_h: int,
            buf_w: int, linear_light: bool, sample_kind: str, *,
            q=None, presets=None, per: int = 0, streams=()):
    """One launch of csrc/frontend.cu: the q/dc epilogue when q is given,
    else the tokens epilogue into `streams` (tokens, clusters, residues,
    residue_bits, valid_len).  Returns lf_q."""
    dev = pixels.device
    tab = _tables(dev)
    lf_q = torch.empty((buf_h >> 3, buf_w >> 3, 3), dtype=torch.int32,
                       device=dev)
    ptrs = [None if t is None else t.data_ptr()
            for t in (q, presets, *(streams or [None] * 5))]
    rc = _kernels.lib().hyd_frontend(
        pixels.data_ptr(), _KIND[pixels.dtype], pixels.shape[0],
        pixels.shape[1], min(int(height), buf_h), min(int(width), buf_w),
        buf_h >> 8, buf_w >> 8, _SCALE[sample_kind], int(linear_light),
        tab.ftab.data_ptr(), tab.itab.data_ptr(), 0 if q is not None else 1,
        ptrs[0], lf_q.data_ptr(), ptrs[1], per, *ptrs[2:],
        _kernels.stream_ptr(pixels))
    _kernels.check(rc, "frontend")
    return lf_q


def frontend_lfg(pixels: torch.Tensor, height: int, width: int, *,
                 buf_h: int, buf_w: int, linear_light: bool,
                 sample_kind: str):
    """The fused front over one LF-group buffer: pixels [uh <= buf_h,
    uw <= buf_w, 3] u8/u16/f32, true extent (height, width) -> (q_flat
    i32 [N, 64] in flat group order, lf_q i32 [buf_h/8, buf_w/8, 3]).
    CUDA tensors launch the kernel, CPU tensors take the plain twin."""
    if pixels.device.type == "cpu":
        return frontend_lfg_plain(pixels, height, width, buf_h=buf_h,
                                  buf_w=buf_w, linear_light=linear_light,
                                  sample_kind=sample_kind)
    pixels = _checked(pixels, buf_h, buf_w, sample_kind)
    q = torch.empty(((buf_h >> 8) * (buf_w >> 8) * 3072, 64),
                    dtype=torch.int32, device=pixels.device)
    lf_q = _launch(pixels, height, width, buf_h, buf_w, linear_light,
                   sample_kind, q=q)
    frontend_groups.launches += 1
    return q, lf_q


def _as_groups(fn, pixels, linear_light, sample_kind):
    G = pixels.shape[0]
    q, dc = fn(pixels.reshape(G * 256, 256, 3), G * 256, 256,
               buf_h=G * 256, buf_w=256, linear_light=linear_light,
               sample_kind=sample_kind)
    return q.reshape(G, 1024, 3, 64), dc.reshape(G, 32, 32, 3)


def frontend_groups_plain(pixels: torch.Tensor, *, linear_light: bool,
                          sample_kind: str):
    """Plain twin in the JAX function's layout: pixels [G, 256, 256, 3]
    -> (q [G, 1024, 3, 64] i32 emission order, dc [G, 32, 32, 3] i32)."""
    return _as_groups(frontend_lfg_plain, pixels, linear_light, sample_kind)


def frontend_groups(pixels: torch.Tensor, *, linear_light: bool,
                    sample_kind: str):
    """Twin of hydrium_tpu.ops.pallas.frontend.frontend_groups: pixels
    [G, 256, 256, 3] -> (q [G, 1024, 3, 64] i32 emission order, dc
    [G, 32, 32, 3] i32).  `frontend_groups.launches` counts launches of
    the kernel, from this function and from frontend_lfg."""
    return _as_groups(frontend_lfg, pixels.contiguous(), linear_light,
                      sample_kind)


frontend_groups.launches = 0


def frontend_tokens_plain(pixels: torch.Tensor, height: int, width: int,
                          presets: torch.Tensor, *, buf_h: int, buf_w: int,
                          linear_light: bool, sample_kind: str,
                          clusters_per_preset: int):
    """Plain twin of the tokens epilogue: frontend_lfg_plain, then
    front.tokenize_lfg (tokenize_flat and the extent mask).  Returns
    {lf_q, tokens, clusters, residues, residue_bits, valid_len}."""
    q, lf_q = frontend_lfg_plain(pixels, height, width, buf_h=buf_h,
                                 buf_w=buf_w, linear_light=linear_light,
                                 sample_kind=sample_kind)
    out = _front.tokenize_lfg(q, presets, height, width, buf_h=buf_h,
                              buf_w=buf_w,
                              clusters_per_preset=clusters_per_preset,
                              tabs=_tables(pixels.device))
    return {"lf_q": lf_q, **out}


def frontend_tokens(pixels: torch.Tensor, height: int, width: int,
                    presets: torch.Tensor, *, buf_h: int, buf_w: int,
                    linear_light: bool, sample_kind: str,
                    clusters_per_preset: int):
    """The fused front with the tokenizer: pixels [uh <= buf_h, uw <=
    buf_w, 3], true extent (height, width), presets [G] per buffer group
    -> {lf_q i32 [buf_h/8, buf_w/8, 3], tokens i16 [N, 64] (u16 bits),
    clusters u8, residues i32 (u32 bits), residue_bits u8, valid_len i32
    [N]}, as front_tokens reads them.  CUDA tensors launch the kernel's
    tokens epilogue (`frontend_tokens.launches` counts them), CPU
    tensors take the plain twin."""
    if pixels.device.type == "cpu":
        return frontend_tokens_plain(
            pixels, height, width, presets, buf_h=buf_h, buf_w=buf_w,
            linear_light=linear_light, sample_kind=sample_kind,
            clusters_per_preset=clusters_per_preset)
    pixels = _checked(pixels, buf_h, buf_w, sample_kind)
    dev = pixels.device
    G = (buf_h >> 8) * (buf_w >> 8)
    presets = presets.to(device=dev, dtype=torch.int32).contiguous()
    if presets.shape != (G,):
        raise ValueError(f"frontend_tokens: presets {tuple(presets.shape)}"
                         f", want ({G},)")
    N = G * 3072
    streams = [torch.empty((N, 64), dtype=dt, device=dev)
               for dt in (torch.int16, torch.uint8, torch.int32,
                          torch.uint8)]
    streams.append(torch.empty(N, dtype=torch.int32, device=dev))
    lf_q = _launch(pixels, height, width, buf_h, buf_w, linear_light,
                   sample_kind, presets=presets, per=int(clusters_per_preset),
                   streams=streams)
    frontend_tokens.launches += 1
    return dict(zip(("lf_q", "tokens", "clusters", "residues",
                     "residue_bits", "valid_len"), [lf_q, *streams]))


frontend_tokens.launches = 0
