"""Single-device example + multi-device dry run of the packed pipeline."""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..encoder import _current
from ..host import _parse_packed, packed_verify
from ..jxl.frame import HFStream, LFGroupGeometry
from ..jxl.tokcode import LF_CLASS, TokenCodec
from ..ops import packed as _packed
from ..ops.constants import packed_aux_len
from ..ops.front import FrontEnd
from . import shard


def entry(device="cuda"):
    """(fn, example_args): the single-LF-group encode pipeline in its
    production (packed-payload) form on `device` -- 256x256 u8 pixels
    to the combined payload."""
    dev = resolve_device(device)
    front = FrontEnd.from_tables().to(dev)
    lens, codes, _lut = TokenCodec().tables()
    h = w = 256
    pixels = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (h, w, 3), dtype=np.uint8), device=dev)
    presets = torch.zeros(1, dtype=torch.int32, device=dev)

    def fn(pixels, presets, lens, codes):
        with _current(pixels.device):
            return _packed.encode_lfg_packed(
                front, pixels, h, w, presets, lens, codes, buf_h=h,
                buf_w=w, linear_light=False, sample_kind="uint8")

    return fn, (pixels, presets,
                torch.as_tensor(lens.astype(np.int32), device=dev),
                torch.as_tensor(codes.astype(np.int32), device=dev))


def dryrun_multichip(n_devices: int, devices=None):
    """Run one packed 256x256 LF group on each of n_devices entries of
    `devices` (default: the first n_devices cards; an entry may repeat)
    with presets arange(n) % 256, and drive the payloads through the
    host plane: parse, checksum verify, the C++ walk and the ANS encode
    -- the same path the sharded and multi-process drivers use, end to
    end.  Prints one line; returns (symbols walked, ANS section bytes)."""
    if devices is None:
        devices = shard.make_devices(n_devices)
    devices = [resolve_device(d) for d in devices]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for {n_devices} LF groups")
    n_lfgs = n_devices             # one 256x256 LF group per device
    num_presets = min(n_lfgs, 256)
    hf = HFStream(num_presets)
    num_clusters = int(hf.cluster_map.max()) + 1
    tok_classes = num_clusters // num_presets

    codec = TokenCodec()
    lens, codes, full_lut = codec.tables()
    lut = full_lut[:tok_classes]                  # match device class count
    lf_lut = full_lut[LF_CLASS]                   # LF stream decode row
    fronts = {d: FrontEnd.from_tables().to(d)
              for d in dict.fromkeys(devices)}
    rng = np.random.default_rng(0)
    pixels = rng.integers(0, 256, (n_lfgs, 256, 256, 3), dtype=np.uint8)
    presets = np.arange(n_lfgs, dtype=np.int32) % 256

    combined = []
    for j, dev in enumerate(devices):
        with _current(dev):
            combined.append(_packed.encode_lfg_packed(
                fronts[dev], torch.as_tensor(pixels[j], device=dev), 256,
                256, torch.full((1,), int(presets[j]), dtype=torch.int32,
                                device=dev),
                torch.as_tensor(lens.astype(np.int32), device=dev),
                torch.as_tensor(codes.astype(np.int32), device=dev),
                buf_h=256, buf_w=256, linear_light=False,
                sample_kind="uint8", tok_classes=tok_classes))

    # host plane: parse + checksum-verify + threaded walk + ANS encode
    A = packed_aux_len(256, 256)
    geom = LFGroupGeometry(x=0, y=0, width=256, height=256,
                           tile_count_x=1, tile_count_y=1)
    total_syms = 0
    for j, c in enumerate(combined):
        payload = c.cpu().numpy()
        aux, words = payload[:A], payload[A:].view(np.uint32)
        if aux[0] != 1:
            raise RuntimeError(f"LF group {j} did not pack (ok {aux[0]})")
        if not packed_verify(aux, words):
            raise RuntimeError(f"LF group {j}: payload checksum mismatch")
        parsed = _parse_packed(aux, words, 256, 256, geom, lf_lut)
        if parsed is None:
            raise RuntimeError(f"LF group {j}: LF stream decode failed")
        hf.add_lfg_packed(parsed["tok_words"], parsed["res_words"], lut,
                          int(presets[j]), (1, 1), (32, 32),
                          parsed["tok_off"], parsed["res_off"],
                          parsed["gs"])
        total_syms += int(parsed["gs"].sum())
    hf.encode_group_sections()
    section_bytes = sum(len(w) for w in hf.group_sections)
    if total_syms <= 0 or section_bytes <= 0:
        raise RuntimeError("dry run walked nothing")
    print(f"dryrun_multichip({n_devices}): ok, {total_syms} symbols "
          f"walked, {section_bytes} ANS section bytes")
    return total_syms, section_bytes
