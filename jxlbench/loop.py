"""The system under test as a library caller drives it: one
hydrium_tpu_torch.Encoder per image, host uint8 arrays in, .jxl bytes out.

One-frame: one send_tile per 2048^2 LF group, then take_output.  Tiled:
one send_tile_batch per row of tiles, then take_output.  An image is
complete when its last take_output has returned and the device is
synchronized.  The window encodes the pool's images in turn, back to
back, a closed loop of the traffic's clients."""

from __future__ import annotations

import hashlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

# what the harness can drive and the reference can judge: a
# configuration that states anything else is refused, not run as these
SAMPLE_FORMATS = ("uint8",)
# precision -> whether TF32 may run in the front's matrix products
PRECISIONS = {"float32 front, TF32 off": False}


@dataclass
class ImageRecord:
    wall_s: float
    nbytes: int
    pixels: int
    stages: Dict[str, float]
    counters: Dict[str, int]


@dataclass
class Window:
    """What the measured window produced."""
    seconds: float
    images: List[ImageRecord]
    # pool index -> {sha256: bytes} of the distinct files it gave
    files: Dict[int, Dict[str, bytes]]
    # pool index -> the window images that gave each file, by sha256
    uses: Dict[int, Dict[str, int]]
    graphs: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    host_events: list = field(default_factory=list)
    start: float = 0.0

    @property
    def pixels(self) -> int:
        return sum(r.pixels for r in self.images)


class Loop:
    def __init__(self, config: dict, device) -> None:
        import torch

        from hydrium_tpu_torch.config import ImageMetadata, SampleFormat
        from hydrium_tpu_torch.encoder import Encoder

        if config["sample_format"] not in SAMPLE_FORMATS:
            raise ValueError(f"jxlbench: sample_format "
                             f"{config['sample_format']!r} is not one the "
                             f"harness drives ({', '.join(SAMPLE_FORMATS)})")
        if config["precision"] not in PRECISIONS:
            raise ValueError(f"jxlbench: precision {config['precision']!r} "
                             f"is not one of {sorted(PRECISIONS)}")
        self.torch = torch
        self.device = torch.device(device)
        self.Encoder, self.ImageMetadata = Encoder, ImageMetadata
        self.fmt = SampleFormat(config["sample_format"])
        self.tf32 = PRECISIONS[config["precision"]]
        self.tile = config["tile_size"]
        self.fused = config["fused_front"]

    def assert_precision(self) -> None:
        """Raises where the program's float settings depart from the
        configuration's precision (checked once the encoder has set them,
        after the warm-up)."""
        b = self.torch.backends
        on = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        if any(on) and not self.tf32:
            raise RuntimeError(f"jxlbench: TF32 is on (matmul, cudnn = {on})"
                               ", the configuration states it off")

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def encode(self, img: np.ndarray, timeline: bool = False):
        h, w = img.shape[:2]
        shift = -1 if self.tile < 0 else (self.tile // 256).bit_length() - 1
        meta = self.ImageMetadata(width=w, height=h, tile_size_shift_x=shift,
                                  tile_size_shift_y=shift)
        enc = self.Encoder(meta, device=self.device, fused_front=self.fused)
        if timeline:
            enc.stats.enable_timeline()
        out = bytearray()
        ts = 2048 if shift < 0 else meta.tile_width
        for ty in range((h + ts - 1) // ts):
            row = img[ty * ts:(ty + 1) * ts]
            if shift < 0:
                for tx in range((w + ts - 1) // ts):
                    enc.send_tile(row[:, tx * ts:(tx + 1) * ts], tx, ty,
                                  sample_fmt=self.fmt)
                    out.extend(enc.take_output())
            else:
                enc.send_tile_batch(
                    [(row[:, tx * ts:(tx + 1) * ts], tx, ty)
                     for tx in range((w + ts - 1) // ts)],
                    sample_fmt=self.fmt)
                out.extend(enc.take_output())
        self.sync()
        return bytes(out), enc.stats

    def warm(self, images: np.ndarray, count: int) -> None:
        """The warm-up: `count` images of the pool encoded one after the
        other, so that every graph key is captured in set-up (a key
        captures at its second dispatch) and the window only replays."""
        for i in range(count):
            self.encode(images[i % len(images)])
        self.sync()

    def graph_counts(self) -> Dict[str, float]:
        from hydrium_tpu_torch.ops import graphs

        tot = {"eager": 0, "captures": 0, "replays": 0, "reserved_mib": 0.0}
        for st in graphs.graph_stats().values():
            for k in tot:
                tot[k] += st.get(k, 0)
        return tot

    def launches(self) -> Dict[str, int]:
        from hydrium_tpu_torch.ops import bitpack, frontend, transport

        fns = {"transport_prep": transport.transport_prep,
               "chunk_pack": bitpack.pack_chunks,
               "frontend_tokens": frontend.frontend_tokens}
        return {k: int(getattr(f, "launches", 0)) for k, f in fns.items()}

    def window(self, images: np.ndarray, seconds: float,
               timeline: bool = False, marker=None,
               clients: int = 1) -> Window:
        """Encode images[i % pool] back to back until `seconds` have
        passed; the last image started runs to its end.  With clients >
        1, that many threads do so at once, client c starting at image c,
        and the window closes when the last of them is done."""
        g0, l0 = self.graph_counts(), self.launches()
        pool = len(images)
        records: List[ImageRecord] = []
        files: Dict[int, Dict[str, bytes]] = {i: {} for i in range(pool)}
        uses: Dict[int, Dict[str, int]] = {i: {} for i in range(pool)}
        events: list = []
        self.sync()
        t0 = time.perf_counter()
        ctx = marker() if marker else None
        if ctx is not None:
            ctx.__enter__()
        lock = threading.Lock()

        def client(c: int) -> float:
            i = c
            while True:
                k = i % pool
                ta = time.perf_counter()
                data, stats = self.encode(images[k], timeline)
                tb = time.perf_counter()
                h, w = images[k].shape[:2]
                key = hashlib.sha256(data).hexdigest()
                with lock:
                    records.append(ImageRecord(
                        tb - ta, len(data), h * w,
                        dict(stats.stage_seconds), dict(stats.counters)))
                    if stats.events:
                        events.extend(stats.events)
                    files[k].setdefault(key, data)
                    uses[k][key] = uses[k].get(key, 0) + 1
                i += clients
                if tb - t0 >= seconds:
                    return tb

        try:
            if clients == 1:
                tb = client(0)
            else:
                with ThreadPoolExecutor(clients,
                                        thread_name_prefix="client") as ex:
                    tb = max(f.result() for f in
                             [ex.submit(client, c) for c in range(clients)])
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
        g1, l1 = self.graph_counts(), self.launches()
        graphs = {k: g1[k] - g0[k] for k in ("eager", "captures", "replays")}
        graphs["reserved_mib"] = g1["reserved_mib"]
        return Window(seconds=tb - t0, images=records, files=files, uses=uses,
                      graphs=graphs, launches={k: l1[k] - l0[k] for k in l1},
                      host_events=events, start=t0)
