"""Sharded one-frame encoding: LF groups data-parallel over a list of
torch devices, bitstream assembled on the host.

2048x2048 LF groups are the shard unit (no halo exchange is needed --
LF prediction and nz prediction never cross LF-group or group
boundaries), histogram presets align with shard boundaries (so there is
no cross-shard reduction), and the variable-length group sections are
gathered on the host.

The encode is the streaming one-frame Encoder's, with each LF group
dispatched to its own entry of the device list, so the output bytes
equal the single-device Encoder's for the same image and front."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import ImageMetadata, SampleFormat
from ..device import resolve_device
from ..encoder import Encoder, _TorchDispatch, encode_image
from ..jxl.tokcode import TokenCodec
from ..ops.front import FrontEnd
from ..utils.stats import EncodeStats
from . import shard


class _ShardedEncoder(Encoder):
    """The streaming one-frame Encoder with LF group i dispatched to
    devices[i % len(devices)], one front per distinct device, at least
    one LF group in flight per entry, and a transport codec of its own
    that starts cold and is never saved as the process's warm state."""

    def __init__(self, metadata: ImageMetadata, devices: list,
                 fused_front: Optional[bool]) -> None:
        super().__init__(metadata, device=devices[0], streaming=True,
                         fused_front=fused_front)
        self._devices = devices
        self._fronts = {d: self._front if d == self.device
                        else FrontEnd.from_tables().to(d)
                        for d in dict.fromkeys(devices)}
        self.max_inflight = max(self.max_inflight, len(devices) - 1)

    def _new_codec(self) -> TokenCodec:
        return TokenCodec()

    def _dispatch(self, pixels, fmt: str, lfg, preset: int, hf,
                  lf_seg_vb: int = 0) -> _TorchDispatch:
        lfid = lfg.y * self.metadata.lfg_count_x + lfg.x
        dev = self._devices[lfid % len(self._devices)]
        return _TorchDispatch(
            pixels, fmt, self.metadata.linear_light, lfg, preset, hf,
            self._codec, self._fronts[dev], dev, self.stats,
            fused=self.fused_front, lf_seg_vb=lf_seg_vb)

    def _finish(self) -> None:
        self._finished = True
        self._stop_workers()


def encode_image_sharded(image: np.ndarray, devices=None,
                         linear_light: bool = False,
                         sample_fmt: str = "uint8",
                         stats: Optional[EncodeStats] = None,
                         fused_front: Optional[bool] = None) -> bytes:
    """Encode [H, W, 3] as a one-frame .jxl with LF groups spread over
    `devices`, a list of devices (default: every visible card).  An
    entry may repeat: ["cuda:0", "cuda:0"] runs two LF groups at a time
    on one card, ["cpu"] * k runs on the CPU.

    Each LF group is one packed dispatch (encoder._TorchDispatch) on its
    entry's device; its payload comes back on a thread of its own and
    the Encoder's drain worker walks the payloads into the HF stream in
    LF-group order (a payload that does not pack runs the unpacked path
    on its own device).  The transport codec is the call's own and
    starts cold.  `stats` receives the dispatches' counters and stage
    times."""
    if devices is None:
        devices = shard.make_devices()
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("no devices to shard over")
    h, w = image.shape[:2]
    fmt = SampleFormat(sample_fmt)
    if h <= 256 and w <= 256:
        # single-group frame: 1-entry TOC, nothing to shard -- use the
        # regular encoder (same bytes; it picks the at-finalize assembler)
        return encode_image(image, tile_size_shift=-1,
                            linear_light=linear_light, sample_fmt=fmt,
                            device=devices[0], stats=stats,
                            fused_front=fused_front)
    meta = ImageMetadata(width=w, height=h, linear_light=linear_light)
    enc = _ShardedEncoder(meta, devices, fused_front)
    if stats is not None:
        enc.stats = stats
    for ty in range(meta.lfg_count_y):
        for tx in range(meta.lfg_count_x):
            enc.send_tile(image[ty * 2048:(ty + 1) * 2048,
                                tx * 2048:(tx + 1) * 2048], tx, ty,
                          sample_fmt=fmt)
    return enc.take_output()
