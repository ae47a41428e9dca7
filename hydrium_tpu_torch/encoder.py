"""Streaming encoder on a PyTorch device, in one-frame and tiled mode.

The device half of hydrium_tpu's jax backend, ported: each LF group (in
tiled mode: each tile, or a stack of full-size tiles) runs the packed
pipeline (ops/packed.py) on the device, the host copies back the aux
prefix and then exactly the stream words it needs, and the jax-free
host plane of hydrium_tpu (payload parser, C++ walker, ANS, frame/TOC
assembly, streaming output) does the rest.  Frame assembly and the
tiled-mode unit bookkeeping are inherited from hydrium_tpu.encoder.
Encoder, so the output bytes follow the same code as backend="jax".

Dispatch is synchronous: dispatch, then copy back, per LF group or
stacked chunk.  The native serialization plane is required (the packed
path is where the device kernels are).  The transport code starts from
its generic prior in every Encoder and never touches the JAX package's
on-disk warm state; it changes payload size, never output bytes.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from hydrium_tpu import encoder as _host
from hydrium_tpu.config import ImageMetadata, SampleFormat
from hydrium_tpu.jxl.frame import HFStream, LFGroupGeometry
from hydrium_tpu.jxl.tokcode import LF_CLASS, TokenCodec
from hydrium_tpu.utils.stats import EncodeStats

from .device import resolve_device
from .host import ensure_native
from .ops import front as _front
from .ops import packed as _packed
from .ops.constants import packed_aux_len
from .ops.frontend import default_fused


class _TorchDispatch:
    """One LF group (or tile, or stack of tiles) on the device: packed
    dispatch, the device-to-host copy of its payload (fetch), and the
    host walk into the HF stream (drain).  fused selects the fused
    front; lf_seg_vb > 0 restarts LF prediction every lf_seg_vb varblock
    rows (stacked tiles are independent frames)."""

    def __init__(self, pixels, sample_fmt: str, linear_light: bool, lfg,
                 preset: int, hf, codec: TokenCodec,
                 front: _front.FrontEnd, device: torch.device,
                 stats: EncodeStats, *, fused: bool = False,
                 lf_seg_vb: int = 0) -> None:
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
        self.fused, self.lf_seg_vb = fused, lf_seg_vb
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
            tok_classes=self.tok_classes, wide_residues=self.wide,
            lf_seg_vb=self.lf_seg_vb, fused=self.fused)

    def fetch(self):
        """Dispatch and copy back: the aux prefix (after the wide retry
        where the payload asks for it) and, for a valid payload, exactly
        the stream words it needs; the aux histogram goes into the codec.
        Returns (aux, words or None).  A checksum mismatch raises: a
        local card has no lossy link that a refetch could fix."""
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
        return aux, words

    def drain(self):
        """Fetch, then walk into the HF stream.  Returns (lf_q, lf_res)
        for the LF group section (one of them None)."""
        aux, words = self.fetch()
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
            sample_kind=self.sample_fmt, lf_seg_vb=self.lf_seg_vb,
            clusters_per_preset=self.tok_classes, fused=self.fused)
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
    """Streaming encoder whose device plane is PyTorch on `device`
    ("cuda" needs a card; "cpu" runs the kernels' plain twins).  The API
    is hydrium_tpu.Encoder's: send_tile, send_tile_batch (tiled mode),
    take_output, iter_output, close.  fused_front selects the fused
    front (ops/frontend.py); None means as HYDRIUM_PALLAS says, which is
    off unless it is "1"."""

    def __init__(self, metadata: ImageMetadata, device="cuda",
                 streaming: Optional[bool] = None,
                 spool_dir: Optional[str] = None,
                 fused_front: Optional[bool] = None) -> None:
        if not ensure_native():
            raise RuntimeError("the native serialization plane "
                               "(cpp/serializer.cc) failed to build; the "
                               "packed device path needs it")
        self.device = resolve_device(device)
        if streaming is None and metadata.one_frame:
            # the jax backend's rule: stream every multi-group one-frame
            # encode (the base class adds the multi-group condition)
            streaming = True
        super().__init__(metadata, backend="torch", streaming=streaming,
                         spool_dir=spool_dir)
        self._codec = TokenCodec()
        self._front = _front.FrontEnd.from_tables().to(self.device)
        self.fused_front = (default_fused() if fused_front is None
                            else bool(fused_front))

    def _dispatch(self, pixels, fmt: str, lfg, preset: int, hf,
                  lf_seg_vb: int = 0) -> _TorchDispatch:
        """Copy `pixels` to the device as one dispatch unit."""
        return _TorchDispatch(
            pixels, fmt, self.metadata.linear_light, lfg, preset, hf,
            self._codec, self._front, self.device, self.stats,
            fused=self.fused_front, lf_seg_vb=lf_seg_vb)

    def _process_lfg(self, pixels, lfid: int, fmt: str) -> None:
        lfg = self._lfgs[lfid]
        self._sent.add(lfid)
        self._geo.lfg_arrival.append(lfid)
        preset = lfid // self._geo.lfg_per_preset
        with self.stats.stage("pipeline+transfer"):
            lf_q, lf_res = self._dispatch(pixels, fmt, lfg, preset,
                                          self._hf).drain()
        self._write_lf(lf_q, lf_res)
        if self.streaming:
            with self.stats.stage("ans_encode"):
                self._hf.finish_lfg(preset)

    # -- tiled mode ------------------------------------------------------
    #
    # send_tile and _tb_drain_all, the frame rendering (_render_tiled_frame,
    # _emit_tiled_frame) and the per-tile render pool (_tb_submit_renders,
    # _tb_pool) are the base class's.  Units are the base class's dicts:
    # "chunk" (a stack of full-size tiles, dispatched and fetched when it
    # is made, its tiles rendered on the pool) and "edge" (one clipped
    # tile, dispatched when it is made, walked when it drains).

    def _send_tile_tiled(self, pixels, tile_x, tile_y, is_last, fmt) -> None:
        m = self.metadata
        lfg = self._tile_geometry(tile_x, tile_y)
        last = self._tile_is_last(tile_x, tile_y, m.tile_width,
                                  m.tile_height, is_last)
        hf = HFStream(1)
        self.stats.pixels += lfg.height * lfg.width
        with self.stats.stage("pipeline+transfer"):
            lf_q, lf_res = self._dispatch(pixels, fmt, lfg, 0, hf).drain()
        self._emit_tiled_frame(lfg, last, lf_q, lf_res, hf)

    def send_tile_batch(self, entries,
                        sample_fmt: SampleFormat = SampleFormat.UINT8) -> None:
        """Encode several tiled-mode tiles; entries: list of (pixels,
        tile_x, tile_y).  Full-size tiles stack vertically, K =
        HYDRIUM_TB_STACK_PX (4096) / tile height to a buffer, and run as
        one packed dispatch: groups never interact, so each tile's
        streams come back separable, and LF prediction restarts at every
        tile.  A run of full-size tiles persists across calls until it
        fills, an edge tile or the last tile arrives, or the sample
        format changes.  Clipped edge tiles run one at a time.  Frames
        are emitted strictly in send order, all but the last two units
        by the end of each call."""
        if self._finished:
            raise RuntimeError("tile sent after the last tile")
        m = self.metadata
        if m.one_frame:
            for pixels, tx, ty in entries:
                self.send_tile(pixels, tx, ty, sample_fmt=sample_fmt)
            return
        fmt = sample_fmt.value
        tw, th = m.tile_width, m.tile_height
        k_stack = max(1, int(os.environ.get("HYDRIUM_TB_STACK_PX",
                                            "4096")) // th)
        if self._tb_run and self._tb_run_fmt != fmt:
            # a held run never crosses formats: flush it under its own
            self._tb_flush_pending = True
            try:
                self.send_tile_batch(
                    [], sample_fmt=SampleFormat(self._tb_run_fmt))
            finally:
                self._tb_flush_pending = False
        run, self._tb_run = self._tb_run, []
        for pixels, tx, ty in entries:
            lfg = self._tile_geometry(tx, ty)
            self.stats.pixels += lfg.height * lfg.width
            if lfg.height == th and lfg.width == tw:
                run.append((np.array(pixels[:th, :tw], copy=True),
                            tx, ty, lfg))
                if len(run) == k_stack:
                    self._tb_units.append(self._tb_chunk(run, fmt, k_stack))
                    run = []
                continue
            if run:
                self._tb_units.append(self._tb_chunk(run, fmt, k_stack))
                run = []
            hf = HFStream(1)
            handle = self._dispatch(pixels, fmt, lfg, 0, hf)
            include_header = not self._wrote_header
            self._wrote_header = True
            self._tb_units.append({"kind": "edge", "handle": handle,
                                   "hf": hf, "lfg": lfg, "tx": tx, "ty": ty,
                                   "include_header": include_header})
        contains_last = any(self._tile_is_last(tx, ty, tw, th, -1)
                            for _p, tx, ty in entries)
        if run:
            if contains_last or self._tb_flush_pending:
                self._tb_units.append(self._tb_chunk(run, fmt, k_stack))
            else:
                self._tb_run, self._tb_run_fmt = run, fmt
        keep = 0 if contains_last else 2
        while len(self._tb_units) > keep:
            self._tb_drain_unit(self._tb_units.pop(0), fmt)

    def _tb_chunk(self, part, fmt: str, k_stack: int) -> dict:
        """Stack the full-size tiles of `part` ((pixels, tx, ty, lfg)
        each) into one k_stack-tile buffer, dispatch and fetch it, and
        submit its tiles' renders.  On a payload that does not pack
        (ok = 0), the unit keeps no result and re-encodes tile by tile
        when it drains, under its own sample format."""
        m = self.metadata
        tw, th = m.tile_width, m.tile_height
        bh = k_stack * th
        px = np.zeros((bh, tw, 3), dtype=part[0][0].dtype)
        for j, (pixels, _tx, _ty, _g) in enumerate(part):
            px[j * th:(j + 1) * th] = pixels
        # the image-header claim is decided here, in send order
        include_header = not self._wrote_header
        self._wrote_header = True
        geo = LFGroupGeometry(x=0, y=0, width=tw, height=bh,
                              tile_count_x=tw >> 8, tile_count_y=bh >> 8)
        with self.stats.stage("pipeline+transfer"):
            # HFStream(1) sets the class count (9); the walk is per tile
            handle = self._dispatch(px, fmt, geo, 0, HFStream(1),
                                    lf_seg_vb=th >> 3)
            aux, words = handle.fetch()
            parsed = (None if words is None else _host._parse_packed(
                aux, words, bh, tw, geo, handle.lf_lut))
        unit = {"kind": "chunk", "px": px, "fmt": fmt,
                "metas": [(tx, ty, lfg) for _p, tx, ty, lfg in part],
                "tok_classes": handle.tok_classes,
                "include_header": include_header, "result": None,
                "futs": None}
        if parsed is None:
            self.stats.count("lfg_fallback")
            return unit
        self.stats.count("lfg_packed")
        unit["result"] = (parsed, handle.tok_lut)
        self._tb_submit_renders(unit)
        return unit

    def _tb_drain_unit(self, unit, fmt: str) -> None:
        """Emit one unit's frames (send order).  A chunk without a result
        re-encodes its tiles one by one under the sample format it was
        sent with, unit["fmt"]; `fmt`, the current call's, is not used."""
        m = self.metadata
        tw, th = m.tile_width, m.tile_height
        if self._finished:
            raise RuntimeError("tile sent after the last tile")
        if unit["kind"] == "edge":
            last = self._tile_is_last(unit["tx"], unit["ty"], tw, th, -1)
            with self.stats.stage("pipeline+transfer"):
                lf_q, lf_res = unit["handle"].drain()
            self._emit_tiled_frame(unit["lfg"], last, lf_q, lf_res,
                                   unit["hf"],
                                   include_header=unit["include_header"])
            return
        if unit["futs"] is None:
            # the first fallback frame writes the header the unit claimed
            if unit["include_header"]:
                self._wrote_header = False
            for j, (tx, ty, _g) in enumerate(unit["metas"]):
                if self._finished:
                    raise RuntimeError("tile sent after the last tile")
                self._send_tile_tiled(unit["px"][j * th:(j + 1) * th], tx,
                                      ty, -1, unit["fmt"])
            return
        for f, last in unit["futs"]:
            if self._finished:
                raise RuntimeError("tile sent after the last tile")
            self._out.extend(f.result())
            if last:
                self._finished = True


def encode_image(image: np.ndarray, tile_size_shift: int = -1,
                 linear_light: bool = False,
                 sample_fmt: Optional[SampleFormat] = None,
                 device="cuda",
                 stats: Optional[EncodeStats] = None,
                 fused_front: Optional[bool] = None) -> bytes:
    """One-shot encode of an [H, W, 3] array to .jxl bytes on `device`:
    one frame (tile_size_shift -1) or tiles of 256 << tile_size_shift,
    sent through send_tile_batch 16 at a time.  `stats`, when given,
    receives the encode's stage times and counters (lfg_packed,
    lfg_fallback, wide_retries)."""
    if sample_fmt is None:
        sample_fmt = {np.dtype(np.uint8): SampleFormat.UINT8,
                      np.dtype(np.uint16): SampleFormat.UINT16}.get(
                          image.dtype, SampleFormat.FLOAT32)
    h, w = image.shape[:2]
    meta = ImageMetadata(width=w, height=h, linear_light=linear_light,
                         tile_size_shift_x=tile_size_shift,
                         tile_size_shift_y=tile_size_shift)
    enc = Encoder(meta, device=device, fused_front=fused_front)
    if stats is not None:
        enc.stats = stats
    out = bytearray()
    if meta.one_frame:
        tile = 2048
        for ty in range((h + tile - 1) // tile):
            for tx in range((w + tile - 1) // tile):
                y0, x0 = ty * tile, tx * tile
                enc.send_tile(image[y0:y0 + tile, x0:x0 + tile], tx, ty,
                              sample_fmt=sample_fmt)
                out.extend(enc.take_output())
        return bytes(out)
    tw, th = meta.tile_width, meta.tile_height
    entries = [(image[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw], tx, ty)
               for ty in range((h + th - 1) // th)
               for tx in range((w + tw - 1) // tw)]
    for i in range(0, len(entries), 16):
        enc.send_tile_batch(entries[i:i + 16], sample_fmt=sample_fmt)
        out.extend(enc.take_output())
    return bytes(out)
