"""Smooth rendered-graphics test images, made on the device from a seed.

The model of the port's smooth fixture: per channel 128 + 80 *
sin(x / px + phase_c) * cos(y / py - phase_c), gradients that leave few
nonzero HF coefficients.  The seed draws each image's phase offset, so
every seed gives the same amount to code, shifted.

make(params, seed, count, device) -> uint8 array [count, H, W, 3] on the
host; the same seed gives the same images on the same device."""

from __future__ import annotations

import math

import numpy as np
import torch


def make(params: dict, seed: int, count: int, device) -> np.ndarray:
    h, w = params["height"], params["width"]
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :, None]
    phase = torch.tensor(params["phases"], dtype=torch.float32,
                         device=device)
    out = torch.empty((count, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(count):
        shift = torch.rand((), generator=g, device=device) * (2 * math.pi)
        img = params["mean"] + params["amplitude"] * torch.sin(
            xx / params["period_x"] + phase + shift) * torch.cos(
            yy / params["period_y"] - phase - shift)
        out[i] = img.clamp_(0, 255).to(torch.uint8)
    return out.cpu().numpy()
