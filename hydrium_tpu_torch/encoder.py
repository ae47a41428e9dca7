"""One-frame streaming encoder on a PyTorch device.

The device half of hydrium_tpu's jax backend, ported: each LF group
runs the packed pipeline (ops/packed.py) on the device, the host copies
back the aux prefix and then exactly the stream words it needs, and the
jax-free host plane of hydrium_tpu (payload parser, C++ walker, ANS,
frame/TOC assembly, streaming output) does the rest.  Frame assembly is
inherited from hydrium_tpu.encoder.Encoder, so the output bytes follow
the same code as backend="jax".

Scope of this slice: one-frame mode only (tiled mode raises
NotImplementedError), synchronous dispatch then drain per LF group, and
the native serialization plane is required (the packed path is where
the device kernels are).  The transport code starts from its generic
prior in every Encoder and never touches the JAX package's on-disk warm
state; it changes payload size, never output bytes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hydrium_tpu import encoder as _host
from hydrium_tpu.config import ImageMetadata, SampleFormat
from hydrium_tpu.jxl import native
from hydrium_tpu.jxl.tokcode import LF_CLASS, TokenCodec
from hydrium_tpu.utils.stats import EncodeStats

from .device import resolve_device
from .ops import front as _front
from .ops import packed as _packed
from .ops.constants import packed_aux_len


class _TorchDispatch:
    """One LF group on the device: packed dispatch, the device-to-host
    copy of its payload, and the host walk into the HF stream."""

    def __init__(self, pixels, sample_fmt: str, linear_light: bool, lfg,
                 preset: int, hf, codec: TokenCodec,
                 front: _front.FrontEnd, device: torch.device,
                 stats: EncodeStats) -> None:
        h, w = lfg.height, lfg.width
        # 256-multiple buffers of the true extent, uploads bucketed to 32
        # (the JAX package's bucketing, so both compute the same groups)
        self.buf_h = min(lfg.tile_count_y << 8, ((h + 255) >> 8) << 8)
        self.buf_w = min(lfg.tile_count_x << 8, ((w + 255) >> 8) << 8)
        ubuf_h = min(self.buf_h, ((h + 31) >> 5) << 5)
        ubuf_w = min(self.buf_w, ((w + 31) >> 5) << 5)
        px = np.zeros((ubuf_h, ubuf_w, 3), dtype=np.asarray(pixels).dtype)
        px[:h, :w] = pixels[:h, :w]
        self.px = torch.from_numpy(px).to(device)
        self.lfg, self.preset, self.hf = lfg, preset, hf
        self.codec, self.front, self.device = codec, front, device
        self.stats = stats
        self.sample_fmt, self.linear_light = sample_fmt, linear_light
        self.num_clusters = int(hf.cluster_map.max()) + 1
        self.tok_classes = self.num_clusters // hf.num_presets
        G = (self.buf_h >> 8) * (self.buf_w >> 8)
        self.presets = torch.full((G,), preset, dtype=torch.int32,
                                  device=device)
        self.wide = False

    def _dispatch(self) -> torch.Tensor:
        """Run the packed pipeline with a snapshot of the codec: the
        walker must decode with exactly the table the device packed
        with.  The LUT is sliced to this frame's class count so the
        walker's class = cluster % (lut.size/4096) matches the device's."""
        lens, codes, lut = self.codec.tables()
        self.tok_lut = lut[:self.tok_classes]
        self.lf_lut = lut[LF_CLASS]
        return _packed.encode_lfg_packed(
            self.front, self.px, self.lfg.height, self.lfg.width,
            self.presets,
            torch.as_tensor(lens.astype(np.int32), device=self.device),
            torch.as_tensor(codes.astype(np.int32), device=self.device),
            buf_h=self.buf_h, buf_w=self.buf_w,
            linear_light=self.linear_light, sample_kind=self.sample_fmt,
            tok_classes=self.tok_classes, wide_residues=self.wide)

    def drain(self):
        """Dispatch, copy back, walk.  Returns (lf_q, lf_res) for the LF
        group section (one of them None).  A checksum mismatch raises:
        a local card has no lossy link that a refetch could fix."""
        A = packed_aux_len(self.buf_h, self.buf_w)
        while True:
            combined = self._dispatch()
            aux = combined[:A].cpu().numpy()
            if not _host.packed_verify(aux, None, self.buf_h, self.buf_w):
                raise RuntimeError("packed payload aux checksum mismatch")
            if int(aux[0]) == 2 and not self.wide:
                # a residue chunk or field exceeded the fast budget:
                # repack with the wide geometry
                self.wide = True
                self.stats.count("wide_retries")
                continue
            break
        words = None
        if aux[0] & 1:
            need = _host.packed_need_words(aux, self.buf_h, self.buf_w)
            words = combined[A:A + need + 1].cpu().numpy().view(np.uint32)
            if not _host.packed_verify(aux, words, self.buf_h, self.buf_w):
                raise RuntimeError("packed payload stream checksum mismatch")
        self.codec.update(aux[8:648])
        if words is not None:
            parsed = _host._parse_packed(aux, words, self.buf_h, self.buf_w,
                                         self.lfg, self.lf_lut)
            if parsed is not None:
                _host._feed_hf_packed(self.hf, parsed, self.lfg, self.buf_w,
                                      self.buf_h, self.preset, self.tok_lut)
                self.stats.count("lfg_packed")
                return None, parsed["lf_res"]
        self.stats.count("lfg_fallback")
        return self._unpacked()

    def _unpacked(self):
        """The unpacked path (a token outside the transport alphabet or
        residues beyond even the wide budget), still on the device."""
        lfg = self.lfg
        out = _front.encode_lfg(
            self.front, self.px, lfg.height, lfg.width, self.presets,
            buf_h=self.buf_h, buf_w=self.buf_w,
            linear_light=self.linear_light, num_clusters=self.num_clusters,
            sample_kind=self.sample_fmt,
            clusters_per_preset=self.tok_classes)
        vh, vw = lfg.varblock_height, lfg.varblock_width
        bgcx = self.buf_w >> 8
        G = (self.buf_h >> 8) * bgcx
        host = {k: v.cpu().numpy() for k, v in out.items()}
        lf_q = host["lf_q"][:vh, :vw]
        lf_res = host["lf_res"].view(np.uint32)[:vh, :vw]
        tokens = host["tokens"].view(np.uint16).reshape(G, 1024, 3, 64)
        clusters = host["clusters"].reshape(tokens.shape)
        residues = host["residues"].view(np.uint32).reshape(tokens.shape)
        residue_bits = host["residue_bits"].reshape(tokens.shape)
        valid_len = host["valid_len"].reshape(G, 1024, 3)
        for gy in range(lfg.group_count_y):
            for gx in range(lfg.group_count_x):
                gi = gy * bgcx + gx
                self.hf.add_group_padded(tokens[gi], clusters[gi],
                                         residues[gi], residue_bits[gi],
                                         valid_len[gi], self.preset)
        return lf_q, lf_res


class Encoder(_host.Encoder):
    """One-frame streaming encoder whose device plane is PyTorch on
    `device` ("cuda" needs a card; "cpu" runs the kernels' plain twins).
    The API is hydrium_tpu.Encoder's one-frame surface: send_tile,
    take_output, iter_output, close."""

    def __init__(self, metadata: ImageMetadata, device="cuda",
                 streaming: Optional[bool] = None,
                 spool_dir: Optional[str] = None) -> None:
        if not metadata.one_frame:
            raise NotImplementedError(
                "tiled mode (tile_size_shift >= 0) is not ported yet")
        if not native.available():
            raise RuntimeError("the native serialization plane "
                               "(cpp/serializer.cc) failed to build; the "
                               "packed device path needs it")
        self.device = resolve_device(device)
        # the jax backend's rule: stream every multi-group one-frame
        # encode (the base class adds the multi-group condition)
        super().__init__(metadata, backend="torch",
                         streaming=True if streaming is None else streaming,
                         spool_dir=spool_dir)
        self._codec = TokenCodec()
        self._front = _front.FrontEnd.from_tables().to(self.device)

    def _process_lfg(self, pixels, lfid: int, fmt: str) -> None:
        lfg = self._lfgs[lfid]
        self._sent.add(lfid)
        self._geo.lfg_arrival.append(lfid)
        preset = lfid // self._geo.lfg_per_preset
        with self.stats.stage("pipeline+transfer"):
            lf_q, lf_res = _TorchDispatch(
                pixels, fmt, self.metadata.linear_light, lfg, preset,
                self._hf, self._codec, self._front, self.device,
                self.stats).drain()
        self._write_lf(lf_q, lf_res)
        if self.streaming:
            with self.stats.stage("ans_encode"):
                self._hf.finish_lfg(preset)


def encode_image(image: np.ndarray, tile_size_shift: int = -1,
                 linear_light: bool = False,
                 sample_fmt: Optional[SampleFormat] = None,
                 device="cuda",
                 stats: Optional[EncodeStats] = None) -> bytes:
    """One-shot one-frame encode of an [H, W, 3] array to .jxl bytes on
    `device`.  `stats`, when given, receives the encode's stage times
    and counters (lfg_packed, lfg_fallback, wide_retries)."""
    if tile_size_shift >= 0:
        raise NotImplementedError(
            "tiled mode (tile_size_shift >= 0) is not ported yet")
    if sample_fmt is None:
        sample_fmt = {np.dtype(np.uint8): SampleFormat.UINT8,
                      np.dtype(np.uint16): SampleFormat.UINT16}.get(
                          image.dtype, SampleFormat.FLOAT32)
    h, w = image.shape[:2]
    meta = ImageMetadata(width=w, height=h, linear_light=linear_light)
    enc = Encoder(meta, device=device)
    if stats is not None:
        enc.stats = stats
    out = bytearray()
    tile = 2048
    for ty in range((h + tile - 1) // tile):
        for tx in range((w + tile - 1) // tile):
            y0, x0 = ty * tile, tx * tile
            enc.send_tile(image[y0:y0 + tile, x0:x0 + tile], tx, ty,
                          sample_fmt=sample_fmt)
            out.extend(enc.take_output())
    return bytes(out)
