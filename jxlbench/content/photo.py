"""Photographic test images, made on the device from a seed.

The model of the port's photo fixture: a 1/f^a luma field (a = 1.1 by
default), two chroma fields of a steeper spectrum added at a quarter of
the luma's strength, hard region edges from a thresholded very
low-frequency field, and Gaussian sensor noise.  Each field has a fixed
amplitude spectrum and random phases, so every seed gives images of the
same spectrum and contrast: the seed moves where things are, not how
much there is to code.  The edge threshold is a quantile, so the edges
cover the same share of every image.

make(params, seed, count, device) -> uint8 array [count, H, W, 3] on the
host; the same seed gives the same images on the same device."""

from __future__ import annotations

import math

import numpy as np
import torch


def _field(g, f, exponent, shape, device):
    h, w = shape
    phase = torch.rand(f.shape, generator=g, device=device) * (2 * math.pi)
    spec = torch.polar(f.pow(-exponent), phase)
    spec[0, 0] = 0
    x = torch.fft.irfft2(spec, s=(h, w))
    return x / x.std()


def make(params: dict, seed: int, count: int, device) -> np.ndarray:
    h, w = params["height"], params["width"]
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    fy = torch.fft.fftfreq(h, device=device)[:, None]
    fx = torch.fft.rfftfreq(w, device=device)[None, :]
    f = torch.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    out = torch.empty((count, h, w, 3), dtype=torch.uint8, device=device)
    edge_q = 1.0 - params["edge_area"]
    for i in range(count):
        luma = _field(g, f, params["luma_exponent"], (h, w), device)
        low = _field(g, f, params["edge_exponent"], (h, w), device)
        k = max(1, int(edge_q * low.numel()))
        thr = low.reshape(-1).kthvalue(k).values
        edges = (low > thr).float() * params["edge_step"]
        c1 = _field(g, f, params["chroma_exponent"], (h, w), device)
        c2 = _field(g, f, params["chroma_exponent"], (h, w), device)
        a = params["chroma_amount"]
        img = torch.stack([luma + a * c1 + edges, luma + edges,
                           luma + a * c2 + edges], dim=-1)
        img = (img - params["edge_step"] * params["edge_area"]) \
            * params["scale"] + 127.5
        img += torch.randn(img.shape, generator=g, device=device) \
            * params["noise_sigma"]
        out[i] = img.round_().clamp_(0, 255).to(torch.uint8)
    return out.cpu().numpy()
