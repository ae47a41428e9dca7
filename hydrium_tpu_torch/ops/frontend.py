"""The fused front: pixels of an LF-group buffer -> quantized HF
coefficients and LF ints in one pass.  Twin of
hydrium_tpu/ops/pallas/frontend.py.

The CUDA kernel csrc/frontend.cu replaces the TPU kernel
ops/pallas/frontend.py::frontend_groups.  frontend_lfg runs it over an
LF-group buffer and is what the front calls; frontend_groups keeps the
JAX function's signature and layout (it is the same kernel over a
[G*256, 256, 3] buffer).  On a CPU tensor both take the plain twin,
frontend_lfg_plain; on a CUDA tensor they launch the kernel or raise.

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
        tab = _TABLES[dev] = SimpleNamespace(
            basis=basis, w_scaled=w_scaled, lf_shift=lf_shift,
            zz_gather=torch.as_tensor(C.ZZ_GATHER.astype(np.int64),
                                      device=dev),
            # the kernel's view: basis | weights | LF shifts, and ky*8+kx
            ftab=torch.cat([basis.reshape(-1), w_scaled.reshape(-1),
                            lf_shift]),
            zz_pos=torch.as_tensor(C.ZZ_POS, device=dev))
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


def _launch(pixels: torch.Tensor, height: int, width: int, buf_h: int,
            buf_w: int, linear_light: bool, sample_kind: str):
    """Run csrc/frontend.cu over a CUDA buffer; same outputs as
    frontend_lfg_plain."""
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
    gcy, gcx = buf_h >> 8, buf_w >> 8
    dev = pixels.device
    tab = _tables(dev)
    q = torch.empty((gcy * gcx * 3072, 64), dtype=torch.int32, device=dev)
    lf_q = torch.empty((buf_h >> 3, buf_w >> 3, 3), dtype=torch.int32,
                       device=dev)
    rc = _kernels.lib().hyd_frontend(
        pixels.data_ptr(), _KIND[pixels.dtype], pixels.shape[0],
        pixels.shape[1], min(int(height), buf_h), min(int(width), buf_w),
        gcy, gcx, _SCALE[sample_kind], int(linear_light),
        tab.ftab.data_ptr(), tab.zz_pos.data_ptr(), q.data_ptr(),
        lf_q.data_ptr(), _kernels.stream_ptr(pixels))
    _kernels.check(rc, "frontend")
    frontend_groups.launches += 1
    return q, lf_q


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
    return _launch(pixels, height, width, buf_h, buf_w, linear_light,
                   sample_kind)


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
