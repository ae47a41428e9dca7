"""Frame-level serialization: frame headers, TOC permutation (Lehmer),
LFGlobal / LFGroup / HFGlobal / HF-group sections.

Equivalent to the frame machinery of the reference encoder
(encoder.c:241-435, :510-629, :852-1016), restructured around explicit
geometry/data objects instead of in-place encoder state.  The port's
copy of hydrium_tpu/jxl/frame.py; its one change is the mask of
HFStream.add_group_padded's pure-Python branch.
"""

from __future__ import annotations

import itertools
import os
import shutil
import tempfile
import weakref
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..ops import tables
from ..ops.reference import lf_predict_residuals, pack_signed
from .bitwriter import BitWriter, U32Table
from .entropy import EntropyStream, cllog2
from . import native


def new_bitwriter():
    """Native-backed writer when the C++ plane is available."""
    if native.available():
        return native.NativeBitWriter()
    return BitWriter()

FRAME_SIZE_U32 = U32Table(cpos=(0, 256, 2304, 18688), upos=(8, 11, 14, 30))
GLOBAL_SCALE_TABLE = U32Table(cpos=(1, 2049, 4097, 8193), upos=(11, 11, 12, 16))
QUANT_LF_TABLE = U32Table(cpos=(16, 1, 1, 1), upos=(0, 5, 8, 16))
TOC_TABLE = U32Table(cpos=(0, 1024, 17408, 4211712), upos=(10, 14, 22, 30))

# Fixed modular MA trees (encoder.c:114-116): (dist, symbol) pairs.
LF_MA_TREE = ((1, 0), (2, 5), (3, 0), (4, 0), (5, 0))
META_MA_TREE = ((1, 0), (2, 0), (3, 0), (4, 0), (5, 0))


@dataclass
class LFGroupGeometry:
    """Mirror of HYDLFGroup (internal.h:13-19)."""

    x: int
    y: int
    width: int
    height: int
    tile_count_x: int
    tile_count_y: int

    @property
    def varblock_width(self) -> int:
        return (self.width + 7) >> 3

    @property
    def varblock_height(self) -> int:
        return (self.height + 7) >> 3

    @property
    def group_count_x(self) -> int:
        return (self.width + 255) >> 8

    @property
    def group_count_y(self) -> int:
        return (self.height + 255) >> 8

    @property
    def group_count(self) -> int:
        return self.group_count_x * self.group_count_y

    def groups(self):
        """Yield (gy, gx, gh, gw) for each 256x256 group in raster order."""
        for gy in range(self.group_count_y):
            gh = min(256, self.height - (gy << 8))
            for gx in range(self.group_count_x):
                gw = min(256, self.width - (gx << 8))
                yield gy, gx, gh, gw


@dataclass
class FrameGeometry:
    """Everything needed for frame headers and TOC layout."""

    image_width: int
    image_height: int
    one_frame: bool
    lfg_count_x: int       # LF groups per frame row (one-frame mode)
    lf_groups: List[LFGroupGeometry]   # raster order, all LFGs of the frame
    lfg_arrival: List[int]             # raster indices in arrival order

    @property
    def lfg_per_frame(self) -> int:
        return len(self.lf_groups)

    @property
    def frame_width(self) -> int:
        return self.image_width if self.one_frame else self.lf_groups[0].width

    @property
    def frame_height(self) -> int:
        return self.image_height if self.one_frame else self.lf_groups[0].height

    @property
    def frame_groups_x(self) -> int:
        return (self.frame_width + 255) >> 8

    @property
    def frame_groups_y(self) -> int:
        return (self.frame_height + 255) >> 8

    @property
    def num_frame_groups(self) -> int:
        return self.frame_groups_x * self.frame_groups_y

    @property
    def toc_size(self) -> int:
        return (2 + self.num_frame_groups + self.lfg_per_frame
                if self.num_frame_groups > 1 else 1)

    @property
    def num_presets(self) -> int:
        return min(self.lfg_per_frame, 256)

    @property
    def lfg_per_preset(self) -> int:
        return (self.lfg_per_frame + 255) // 256

    @property
    def preset_lfg_counts(self) -> List[int]:
        """LF groups per histogram preset, by preset id."""
        per = self.lfg_per_preset
        return [max(0, min(per, self.lfg_per_frame - p * per))
                for p in range(self.num_presets)]


def one_frame_geometry(width: int, height: int) -> FrameGeometry:
    """A one-frame image's geometry: its 2048x2048 LF groups in raster
    order, none of them arrived yet."""
    count_x, count_y = (width + 2047) >> 11, (height + 2047) >> 11
    lfgs = [LFGroupGeometry(x=x, y=y, width=min(2048, width - x * 2048),
                            height=min(2048, height - y * 2048),
                            tile_count_x=8, tile_count_y=8)
            for y in range(count_y) for x in range(count_x)]
    return FrameGeometry(image_width=width, image_height=height,
                         one_frame=True, lfg_count_x=count_x,
                         lf_groups=lfgs, lfg_arrival=[])


def calculate_toc_permutation(geo: FrameGeometry) -> List[int]:
    """Physical-section-order -> logical-TOC-index map (encoder.c:241-268)."""
    toc = [0] * geo.toc_size
    idx = 1
    for raster in geo.lfg_arrival:
        toc[idx] = 1 + raster
        idx += 1
    for pos, raster in enumerate(geo.lfg_arrival):
        if pos == 0:
            toc[idx] = 1 + geo.lfg_per_frame  # HFGlobal
            idx += 1
        lfg = geo.lf_groups[raster]
        for g in range(lfg.group_count):
            gy = (lfg.y << 3 if geo.one_frame else 0) + g // lfg.group_count_x
            gx = (lfg.x << 3 if geo.one_frame else 0) + g % lfg.group_count_x
            toc[idx] = 2 + geo.lfg_per_frame + gy * geo.frame_groups_x + gx
            idx += 1
    return toc


def lehmer_sequence(geo: FrameGeometry) -> List[int]:
    """Lehmer code of the inverse TOC permutation (encoder.c:270-325)."""
    n = geo.toc_size
    toc = calculate_toc_permutation(geo)
    inverse = [0] * n
    for physical, logical in enumerate(toc):
        inverse[logical] = physical
    temp = list(range(n))
    lehmer = [0] * n
    for i in range(n):
        k = 0
        for j in range(n):
            if temp[j] == inverse[i]:
                lehmer[i] = k
                temp[j] = -1
            elif temp[j] >= 0:
                k += 1
    return lehmer


def write_frame_header(bw: BitWriter, geo: FrameGeometry, is_last: bool) -> None:
    """encoder.c:327-435."""
    bw.zero_pad()
    lfg = geo.lf_groups[0]
    have_crop = not geo.one_frame and not (
        geo.image_width <= lfg.width and geo.image_height <= lfg.height)

    bw.write(0, 1)                      # all_default = 0
    bw.write(0 if is_last else 3, 2)    # kRegularFrame / kSkipProgressive
    bw.write(0, 1)                      # frame_encoding = VarDCT
    bw.write_u64(0x80)                  # flags = kSkipAdaptiveLFSmoothing
    # upsampling 0:2, x_qm_scale 3:3, b_qm_scale 2:3, num_passes 0:2
    bw.write(0x4C, 10)
    bw.write_bool(have_crop)
    if have_crop:
        frame_w = lfg.tile_count_x << 8
        frame_h = lfg.tile_count_y << 8
        bw.write_u32(FRAME_SIZE_U32, int(pack_signed(
            np.int64(lfg.x * frame_w))))
        bw.write_u32(FRAME_SIZE_U32, int(pack_signed(
            np.int64(lfg.y * frame_h))))
        bw.write_u32(FRAME_SIZE_U32, lfg.width)
        bw.write_u32(FRAME_SIZE_U32, lfg.height)
    bw.write(0, 2)                      # blending mode kReplace
    if have_crop:
        bw.write(0, 2)                  # blending source = 0
    bw.write_bool(is_last)
    if not is_last:
        bw.write(0, 2)                  # save_as_reference = 0
    bw.write(0, 2)                      # name_len
    bw.write_bool(False)                # restoration all_default = 0
    bw.write_bool(False)                # gab
    bw.write(0, 2)                      # epf_iters
    bw.write(0, 2)                      # restoration extensions
    bw.write(0, 2)                      # frame extensions

    if geo.toc_size > 1:
        bw.write_bool(True)             # permuted TOC
        stream = EntropyStream([0], 8)
        stream.send_symbol(0, geo.toc_size)
        for v in lehmer_sequence(geo):
            stream.send_symbol(0, v)
        stream.prefix_finalize(bw)
    else:
        bw.write_bool(False)
    bw.zero_pad()


# Sort keys of a one-frame encode's sections: LF global and the LF groups
# take the default key () and leave in the order put; then HF global;
# then the HF groups, which a streaming encode's presets flush out of LF
# group arrival order, by HF_GROUPS_KEY + (arrival, group).
HF_GLOBAL_KEY = (1,)
HF_GROUPS_KEY = (2,)


class FrameSections:
    """The sections of one frame and the TOC that sizes them: the one
    writer of a frame's layout (the reference's working writer and
    section end positions, internal.h:56-67).

    Each section is put raw, as export_raw gives it (bytes, tail_val,
    tail_bits), under a sort key, and sections leave in key order (a
    stable sort).  A frame of several groups pads each section to a byte
    and lists their sizes in its TOC; a frame of one group concatenates
    its sections at bit level under a one-entry TOC.  With spool_dir the
    bytes go to files in a temp subdirectory of the store's own (encoders
    sharing one spool_dir never overwrite each other's files), read back
    in bounded chunks; it is removed when chunks() ends, at close(), or
    by a weakref.finalize backstop at GC or interpreter exit."""

    def __init__(self, multi_section: bool,
                 spool_dir: Optional[str] = None) -> None:
        self.multi_section = multi_section
        # (key, bytes | path, tail_val, tail_bits, nbytes); a streaming
        # encode puts from its drain thread and its calling thread
        self._items: List = []
        self._names = itertools.count()
        self._dir = self._cleanup = None
        if spool_dir is not None:
            self._dir = tempfile.mkdtemp(prefix="hydspool-", dir=spool_dir)
            self._cleanup = weakref.finalize(self, shutil.rmtree,
                                             self._dir, True)

    def add(self, raw, key=()) -> None:
        data, tail_val, tail_bits = raw
        src = data
        if self._dir is not None:
            src = os.path.join(self._dir, f"sec{next(self._names)}.bin")
            with open(src, "wb") as f:
                f.write(data)
        self._items.append((key, src, tail_val, tail_bits, len(data)))

    def write(self, write_section, *args, key=()) -> None:
        """Put the section that write_section(writer, *args) writes."""
        bw = new_bitwriter()
        write_section(bw, *args)
        self.add(bw.export_raw(), key)

    def _ordered(self) -> List:
        self._items.sort(key=lambda item: item[0])
        return self._items

    def items(self):
        """(key, (bytes, tail_val, tail_bits)) per section in key order;
        a spooled section is read whole."""
        for key, src, tail_val, tail_bits, _n in self._ordered():
            if isinstance(src, str):
                with open(src, "rb") as f:
                    src = f.read()
            yield key, (src, tail_val, tail_bits)

    def write_toc(self, bw) -> None:
        """The TOC's section sizes, between two zero-pads."""
        bw.zero_pad()
        if self.multi_section:
            for _k, _s, _v, tail_bits, nbytes in self._ordered():
                bw.write_u32(TOC_TABLE, nbytes + (tail_bits > 0))
        else:
            bits = sum(8 * item[4] + item[3] for item in self._items)
            bw.write_u32(TOC_TABLE, (bits + 7) >> 3)
        bw.zero_pad()

    def chunks(self):
        """The frame's bytes after its TOC, section by section in key
        order; closes the store when done."""
        try:
            if not self.multi_section:
                bw = new_bitwriter()
                for _key, (data, tail_val, tail_bits) in self.items():
                    bw.append_bytes(data)
                    bw.write(tail_val, tail_bits)
                yield bw.finalize()
                return
            for _key, src, tail_val, tail_bits, _n in self._ordered():
                if isinstance(src, str):
                    with open(src, "rb") as f:
                        while chunk := f.read(1 << 22):
                            yield chunk
                else:
                    yield src
                if tail_bits:
                    yield bytes([tail_val & ((1 << tail_bits) - 1)])
        finally:
            self.close()

    def close(self) -> None:
        """Remove the spool directory now (idempotent)."""
        if self._cleanup is not None:
            self._cleanup()


def write_lf_global(bw: BitWriter) -> None:
    """encoder.c:510-537."""
    from ..config import GLOBAL_SCALE, QUANT_LF
    bw.write_bool(True)                       # LF quant all_default
    bw.write_u32(GLOBAL_SCALE_TABLE, GLOBAL_SCALE)
    bw.write_u32(QUANT_LF_TABLE, QUANT_LF)
    bw.write_bool(False)                      # HF block context all_default=0
    bw.write(0, 16)                           # lf/qf thresholds
    bw.write_bool(True)                       # simple clustering
    bw.write(2, 2)                            # nbits = 2
    for i in range(3):
        for _ in range(13):
            bw.write(i, 2)                    # block context cluster map
    bw.write_bool(True)                       # LF channel correlation default
    bw.write_bool(False)                      # GlobalModular have_global_tree


def _send_ma_tree(bw: BitWriter, tree) -> None:
    stream = EntropyStream([0] * 6, 6)
    for dist, sym in tree:
        stream.send_symbol(dist, sym)
    stream.prefix_finalize(bw)


# Constant-segment cache for write_lf_group: the MA trees and the whole
# block-metadata tail are pure functions of (vh, vw), yet tiled mode
# re-encodes them for EVERY 256x256 tile-frame -- measured as the bulk
# of the 70x-per-pixel lf_sections gap vs one-frame mode (BENCH_r04:
# 1340 ms tiled vs 19 ms one-frame for the same pixel count).  A bit
# stream is position-independent (bits append sequentially), so the
# first build's raw export replays byte-for-byte at any alignment.
_SEG_CACHE: dict = {}


def _cached_segment(key, use_native: bool, build):
    seg = _SEG_CACHE.get(key)
    if seg is None:
        w = native.NativeBitWriter() if use_native else BitWriter()
        build(w)
        seg = w.export_raw()
        _SEG_CACHE[key] = seg
    return seg


def _append_raw(bw, seg) -> None:
    data, tail_val, tail_bits = seg
    bw.append_bytes(data)
    if tail_bits:
        bw.write(tail_val, tail_bits)


def write_lf_group(bw, lf_q: Optional[np.ndarray],
                   lf_res_packed: Optional[np.ndarray] = None) -> None:
    """One LFGroup section from quantized LF values.

    lf_q: [vh, vw, 3] int32 (storage channel order X,Y,B), or None when
    lf_res_packed -- a [vh, vw, 3] pack_signed residual array straight
    from the device pipeline -- is given (the packed payload ships only
    residuals; nothing else in the section needs the raw LF values).
    encoder.c:539-629."""
    vh, vw, _ = (lf_q if lf_q is not None else lf_res_packed).shape
    nb_blocks = vh * vw
    use_native = native.available() and isinstance(
        bw, native.NativeBitWriter)

    def head(w):
        w.write(0, 2)          # extra precision
        w.write_bool(False)    # use_global_tree
        w.write_bool(True)     # wp_params all_default
        w.write(0, 2)          # nb_transforms
        _send_ma_tree(w, LF_MA_TREE)

    _append_raw(bw, _cached_segment(("lf_head", use_native),
                                    use_native, head))

    if lf_res_packed is None:
        lf_res_packed = pack_signed(lf_predict_residuals(lf_q))
    # emission order Y, X, B, channel-major (encoder.c:574-594)
    planes = np.concatenate([lf_res_packed[:, :, 1].ravel(),
                             lf_res_packed[:, :, 0].ravel(),
                             lf_res_packed[:, :, 2].ravel()])
    if use_native:
        stream = native.NativeStream([0], 1, custom_config=(7, 1, 1),
                                     lz77_min_symbol=1 << 14, modular=True)
        stream.send_mono(0, planes)
        stream.prefix_finalize(bw)
    else:
        stream = EntropyStream([0], 1, custom_configs=True,
                               lz77_min_symbol=1 << 14, modular=True)
        stream.set_hybrid_config(0, 0, 7, 1, 1)
        for v in planes:
            stream.send_symbol(0, int(v))
        stream.prefix_finalize(bw)

    def meta_tail(w):
        w.write(nb_blocks - 1, cllog2(nb_blocks))
        w.write(0x2, 4)
        _send_ma_tree(w, META_MA_TREE)

        cfl_height = (vh + 7) >> 3
        cfl_width = (vw + 7) >> 3
        num_z_pre = 2 * cfl_width * cfl_height + nb_blocks
        qf_sym = (tables.HF_MULT - 1) * 2
        meta_syms = np.concatenate([
            np.zeros(num_z_pre, np.uint32),
            np.full(nb_blocks, qf_sym, np.uint32),
            np.zeros(nb_blocks, np.uint32)])
        if use_native:
            stream = native.NativeStream([0], 1, lz77_min_symbol=29,
                                         modular=True)
            stream.send_mono(0, meta_syms)
            stream.prefix_finalize(w)
        else:
            stream = EntropyStream([0], 1, lz77_min_symbol=29, modular=True)
            for v in meta_syms:
                stream.send_symbol(0, int(v))
            stream.prefix_finalize(w)

    _append_raw(bw, _cached_segment(("lf_meta", vh, vw, use_native),
                                    use_native, meta_tail))


class HFStream:
    """Frame-wide HF coefficient ANS stream with per-group barriers.

    Accumulates tokenized group symbols, encodes per-group ANS sections
    at preset-flush time, and writes the shared histogram header last
    (encoder.c:852-981, entropy.c ANS path)."""

    def __init__(self, num_presets: int, use_native: Optional[bool] = None) -> None:
        self.num_presets = num_presets
        self.cluster_map = tables.hf_cluster_map(num_presets)
        self.use_native = (native.available() if use_native is None
                           else use_native)
        self.group_sections: List = []
        if self.use_native:
            self._native = native.NativeHF(int(self.cluster_map.max()) + 1)
        else:
            self.stream = EntropyStream(self.cluster_map.tolist(),
                                        len(self.cluster_map),
                                        custom_configs=True)
            self.stream.set_hybrid_config(0, 0, 4, 1, 0)
            self._barriers: List[int] = []
            self._presets: List[int] = []

    def add_group(self, flat_tokens, preset: int) -> None:
        """flat_tokens: (tokens, clusters, residues, residue_bits) arrays in
        emission order for one group.  (Pure-Python mode only.)"""
        assert not self.use_native
        t, c, r, b = flat_tokens
        self.stream.send_tokenized(c, t, r, b)
        self._barriers.append(len(t))
        self._presets.append(preset)

    def add_group_padded(self, tokens, clusters, residues, residue_bits,
                         valid_len, preset: int) -> None:
        """Padded [.., 3, 64] arrays (+ valid_len [.., 3]) straight from the
        device pipeline; the native plane walks the valid prefixes."""
        if self.use_native:
            self._native.add_group(tokens, clusters, residues, residue_bits,
                                   valid_len, preset)
        else:
            # the mask takes valid_len's own rank: [n, 3] for the
            # [n, 3, 64] arrays of the unpacked fallback
            mask = np.arange(64) < np.asarray(valid_len)[..., None]
            self.add_group((np.asarray(tokens)[mask],
                            np.asarray(clusters)[mask],
                            np.asarray(residues)[mask],
                            np.asarray(residue_bits)[mask]), preset)

    def add_lfg_packed(self, tok_words, res_words, tok_lut, preset, grid,
                       extent, tok_bit_offs, res_bit_offs,
                       sym_counts) -> None:
        """Bulk packed walk of a whole LF group (payload v3, threaded in
        C++; handles partial grids / phantom buffer groups itself)."""
        assert self.use_native
        self._native.add_lfg_packed(tok_words, res_words, tok_lut,
                                    self.cluster_map, preset, grid, extent,
                                    tok_bit_offs, res_bit_offs, sym_counts)

    def encode_group_sections(self) -> int:
        """Encode every pending group's ANS section (encoder.c:931-952);
        returns the symbols encoded.

        All sections are encoded here, with the final log_alphabet_size,
        rather than per-preset as tiles arrive -- see the consistency note
        in encoder.py's module docstring.  Byte-identical to the reference
        whenever the reference's own per-flush alphabet size is stable."""
        bits = cllog2(self.num_presets)
        if self.use_native:
            self._native.prepare()
            self.group_sections = self._native.encode_all(bits)
            return self._native.num_symbols
        self.stream.ans_prepare_frequencies(0, self.stream.num_clusters, 0,
                                            self.stream.symbol_count)
        soff = 0
        for count, p in zip(self._barriers, self._presets):
            gbw = BitWriter()
            gbw.write(p, bits)
            self.stream.ans_write_symbols(gbw, soff, count)
            soff += count
            self.group_sections.append(gbw)
        self._barriers.clear()
        self._presets.clear()
        return soff

    def write_hf_global(self, bw, num_frame_groups: int) -> None:
        """encoder.c:959-967."""
        bw.write_bool(True)      # default params
        bw.write(self.num_presets - 1, cllog2(num_frame_groups))
        bw.write(2, 2)           # used_orders: all natural
        if self.use_native:
            self._native.write_header(self.cluster_map, bw)
        else:
            self.stream.ans_write_header(bw)


class StreamingHFStream:
    """Memory-bounded HF stream for gigapixel one-frame encodes.

    Instead of accumulating every group's symbols until finalize (the
    HFStream above), each histogram preset is ANS-encoded as soon as its
    last LF group arrives, and only the *encoded section bytes* are
    retained, in `sections` (the frame's FrameSections, in RAM or
    spooled to disk).  To keep mid-stream encoding consistent with the
    shared histogram header written at the end, the ANS
    log_alphabet_size is fixed at 8 -- self-consistent by construction,
    unlike the reference's evolving value (see encoder.py docstring);
    identical compressed size, different bytes.

    Requires the native serialization plane."""

    FIXED_LAS = 8

    def __init__(self, num_presets: int, lfgs_per_preset_count,
                 sections: FrameSections) -> None:
        """lfgs_per_preset_count: list of LFG counts per preset id."""
        assert native.available(), "streaming mode needs the native plane"
        self.num_presets = num_presets
        self.use_native = True
        self.cluster_map = tables.hf_cluster_map(num_presets)
        self._num_clusters = int(self.cluster_map.max()) + 1
        self._expected = list(lfgs_per_preset_count)
        self._arrived = [0] * num_presets
        self._per_preset: dict = {}
        # group sections are keyed by GLOBAL arrival order: when
        # lfg_per_preset > 1 and tiles arrive out of order, presets can
        # flush out of arrival order, but the TOC permutation assumes
        # sections appear in LFG-arrival order (calculate_toc_permutation)
        self.sections = sections
        self._freqs: dict = {}
        # arrival bookkeeping: groups added since the preset's last
        # finish_lfg, and (arrival_idx, n_groups) runs per preset
        self._pending_groups = [0] * num_presets
        self._lfg_runs: dict = {p: [] for p in range(num_presets)}
        self._global_arrival = 0

    def _preset_hf(self, preset: int) -> native.NativeHF:
        hf = self._per_preset.get(preset)
        if hf is None:
            hf = native.NativeHF(self._num_clusters)
            hf.force_las(self.FIXED_LAS)
            self._per_preset[preset] = hf
        return hf

    def add_lfg_packed(self, tok_words, res_words, tok_lut, preset, grid,
                       extent, tok_bit_offs, res_bit_offs,
                       sym_counts) -> None:
        self._preset_hf(preset).add_lfg_packed(
            tok_words, res_words, tok_lut, self.cluster_map, preset, grid,
            extent, tok_bit_offs, res_bit_offs, sym_counts)
        # only real (non-phantom) buffer groups produce HF sections
        vh, vw = extent
        gcy, gcx = grid
        real = min((vh + 31) >> 5, gcy) * min((vw + 31) >> 5, gcx)
        self._pending_groups[preset] += real

    def finish_lfg(self, preset: int) -> int:
        """Signal that one LF group of `preset` has been fully added;
        returns the symbols ANS-encoded (the preset's, at its last LF
        group, else 0)."""
        self._lfg_runs[preset].append(
            (self._global_arrival, self._pending_groups[preset]))
        self._global_arrival += 1
        self._pending_groups[preset] = 0
        self._arrived[preset] += 1
        if self._arrived[preset] == self._expected[preset]:
            return self._flush_preset(preset)
        return 0

    def _flush_preset(self, preset: int) -> int:
        hf = self._per_preset.pop(preset)
        hf.prepare()
        writers = hf.encode_all(cllog2(self.num_presets))
        # assign arrival keys: the preset's groups were added in its own
        # LFG arrival order, in runs recorded by finish_lfg
        keys = []
        for arrival_idx, n_groups in self._lfg_runs[preset]:
            keys.extend((arrival_idx, j) for j in range(n_groups))
        assert len(keys) == len(writers)
        for key, w in zip(keys, writers):
            self.sections.add(w.export_raw(), HF_GROUPS_KEY + key)
        # clusters for this preset occupy a contiguous id range
        per = self._num_clusters // self.num_presets
        for c in range(per * preset, per * (preset + 1)):
            self._freqs[c] = hf.frequencies(c)
        return hf.num_symbols

    def frequencies(self) -> dict:
        """{cluster: normalized frequency table} of the presets flushed
        so far."""
        return dict(self._freqs)

    def add_group_padded(self, tokens, clusters, residues, residue_bits,
                         valid_len, preset: int) -> None:
        self._preset_hf(preset).add_group(tokens, clusters, residues,
                                          residue_bits, valid_len, preset)
        self._pending_groups[preset] += 1

    def encode_group_sections(self) -> int:
        assert not self._per_preset, "unflushed presets remain"
        return 0

    def write_hf_global(self, bw, num_frame_groups: int) -> None:
        write_hf_global_fixed_las(bw, self.cluster_map, self.num_presets,
                                  self._freqs, num_frame_groups,
                                  self.FIXED_LAS)


def write_hf_global_fixed_las(bw, cluster_map, num_presets: int, freqs,
                              num_frame_groups: int, fixed_las: int) -> None:
    """HFGlobal + shared ANS histogram header with a fixed
    log_alphabet_size (the streaming / multi-host scheme -- sections can
    be encoded before the whole frame's alphabet is known because the
    las never changes; see StreamingHFStream).  `freqs` maps cluster c
    to its normalized frequency table; a cluster absent, or with an
    empty table, saw no symbols."""
    from .entropy import write_cluster_map, write_ans_frequencies
    from .entropy import write_hybrid_uint_config

    num_clusters = int(cluster_map.max()) + 1
    bw.write_bool(True)
    bw.write(num_presets - 1, cllog2(num_frame_groups))
    bw.write(2, 2)
    # ANS stream header with the fixed las
    bw.write_bool(False)  # lz77
    write_cluster_map(bw, cluster_map, len(cluster_map), num_clusters)
    bw.write_bool(False)  # use_prefix_codes
    bw.write(fixed_las - 5, 2)
    for _ in range(num_clusters):
        write_hybrid_uint_config(bw, (4, 1, 0), fixed_las)
    for c in range(num_clusters):
        f = freqs.get(c)
        if f is None or len(f) == 0:
            write_ans_frequencies(bw, [], 0)
        else:
            write_ans_frequencies(bw, [int(v) for v in f], len(f))
