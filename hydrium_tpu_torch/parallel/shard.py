"""Sharded encode steps over a list of torch devices.

The JPEG XL group structure gives the parallel decomposition for free:
256x256 groups (and 2048x2048 LF groups) are independent except for
  - per-preset histograms, shared across a frame -> summed over the
    devices,
  - the host-side bitstream gather (variable-length).

Each device runs the unpacked single-LF-group pipeline (ops/front.py
encode_lfg) on its contiguous block of LF groups; the per-cluster
histograms are summed over every device onto the first, so any caller
can serialize any preset's header.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..encoder import _current
from ..ops import front as _front
from ..ops import tables


def make_devices(n_devices: Optional[int] = None) -> List[torch.device]:
    """The first n_devices visible cards (all of them by default);
    raises when there is no card."""
    resolve_device("cuda")
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    return cards[:n_devices or len(cards)]


def sharded_lfg_encode(devices, *, lfg_dim: int, linear_light: bool,
                       num_presets: int, sample_kind: str = "uint8"):
    """Build a function encoding a batch of LF groups over `devices`.

    Returns fn(pixels [N, lfg_dim, lfg_dim, 3], presets [N]) ->
    (dict of per-LF-group outputs stacked on axis 0, the per-cluster
    histogram [num_clusters, 128] summed over every LF group), all on
    the first device.  Device d takes the d-th contiguous block of
    N / len(devices) LF groups; N must be a multiple of len(devices)."""
    devices = [resolve_device(d) for d in devices]
    num_clusters = int(tables.hf_cluster_map(num_presets).max()) + 1
    fronts = {d: _front.FrontEnd.from_tables().to(d)
              for d in dict.fromkeys(devices)}
    gc = max(lfg_dim >> 8, 1) ** 2
    buf = max(lfg_dim, 256)

    def one_lfg(px: torch.Tensor, preset: int, dev: torch.device):
        with _current(dev):
            return _front.encode_lfg(
                fronts[dev], px, lfg_dim, lfg_dim,
                torch.full((gc,), preset, dtype=torch.int32, device=dev),
                buf_h=buf, buf_w=buf, linear_light=linear_light,
                num_clusters=num_clusters, sample_kind=sample_kind,
                clusters_per_preset=num_clusters // num_presets)

    def step(pixels, presets):
        pixels = np.asarray(pixels)
        presets = np.asarray(presets)
        n = pixels.shape[0]
        if n % len(devices):
            raise ValueError(f"{n} LF groups do not split evenly over "
                             f"{len(devices)} devices")
        per = n // len(devices)
        outs, hists = [], []
        for d, dev in enumerate(devices):
            block = [one_lfg(torch.as_tensor(pixels[i], device=dev),
                             int(presets[i]), dev)
                     for i in range(d * per, (d + 1) * per)]
            if block:
                hists.append(sum(o.pop("hist") for o in block))
            outs.extend(block)
        first = devices[0]
        local = {k: torch.stack([o[k].to(first) for o in outs])
                 for k in outs[0]}
        # clusters are disjoint across presets, so summing every
        # device's counts combines them without conflict
        global_hist = sum(hh.to(first) for hh in hists)
        return local, global_hist

    return step
