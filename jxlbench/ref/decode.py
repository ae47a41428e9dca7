"""Parse a whole JPEG XL file of the encoder under test down to its
quantized coefficients: headers, every frame and its TOC, each section
read exactly to its TOC size, the modular LF and HF metadata streams,
and the ANS-coded HF coefficients of every group.

decode(data) -> Coefficients: lf [vh, vw, 3] int32 (X, Y, B) and hf
[vh, vw, 64, 3] int32 in zig-zag order, for the whole image, however
its frames tile it.  Anything outside the format, or outside what the
encoder documents that it writes (VarDCT, DCT8 only, one pass, fixed
quantizer, no filters, sRGB 8-bit), raises ParseFault."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bits import BitReader, ParseFault, padded
from .entropy import EntropyDecoder
from . import tables as T

_SIZE = ((1, 9), (1, 13), (1, 18), (1, 30))
_FRAME_SIZE = ((0, 8), (256, 11), (2304, 14), (18688, 30))
_TOC = ((0, 10), (1024, 14), (17408, 22), (4211712, 30))
_GLOBAL_SCALE = ((1, 11), (2049, 11), (4097, 12), (8193, 16))
_QUANT_LF = ((16, 0), (1, 5), (1, 8), (1, 16))
_NUM_TRANSFORMS = ((0, 0), (1, 0), (2, 4), (18, 8))
_USED_ORDERS = ((0x5F, 0), (0x13, 0), (0, 0), (0, 13))
_BLEND_MODE = ((0, 0), (1, 0), (2, 0), (3, 2))
_UPSAMPLING = ((1, 0), (2, 0), (4, 0), (8, 0))
_PASSES = ((1, 0), (2, 0), (3, 0), (4, 3))
_NAME_LEN = ((0, 0), (0, 4), (16, 5), (48, 10))
_BITS_PER_SAMPLE = ((8, 0), (10, 0), (12, 0), (1, 6))
_EXTRA_CHANNELS = ((0, 0), (1, 0), (2, 4), (1, 12))

GRADIENT, ZERO = 5, 0


@dataclass
class Coefficients:
    width: int
    height: int
    frames: int
    lf: np.ndarray      # [vh, vw, 3] int32, channels X, Y, B
    hf: np.ndarray      # [vh, vw, 64, 3] int32, zig-zag order


def _unpack(v: int) -> int:
    return -((v + 1) >> 1) if v & 1 else v >> 1


def _ceil_log2(n: int) -> int:
    return (n - 1).bit_length()


def _read_image_header(br: BitReader):
    br.expect(16, 0x0AFF, "signature")
    br.expect(1, 0, "div8")
    height = br.read_u32(_SIZE)
    br.expect(3, 0, "aspect ratio")
    width = br.read_u32(_SIZE)
    br.expect(1, 0, "metadata all_default")
    br.expect(1, 0, "extra_fields")
    br.expect(1, 0, "float samples")
    if br.read_u32(_BITS_PER_SAMPLE) != 8:
        raise ParseFault("bits per sample is not 8")
    br.expect(1, 1, "modular 16-bit buffers")
    if br.read_u32(_EXTRA_CHANNELS) != 0:
        raise ParseFault("extra channels")
    br.expect(1, 1, "xyb_encoded")
    br.expect(1, 1, "colour encoding all_default (sRGB, no ICC)")
    if br.read_u64() != 0:
        raise ParseFault("metadata extensions")
    br.expect(1, 1, "default opsin matrix")
    br.zero_pad()
    return width, height


def _read_frame_header(br: BitReader):
    br.zero_pad()
    br.expect(1, 0, "frame all_default")
    ftype = br.read(2)
    if ftype not in (0, 3):
        raise ParseFault(f"frame type {ftype}")
    br.expect(1, 0, "frame encoding VarDCT")
    if br.read_u64() != 0x80:
        raise ParseFault("frame flags other than skip-adaptive-LF-smoothing")
    if br.read_u32(_UPSAMPLING) != 1:
        raise ParseFault("upsampling")
    br.expect(3, 3, "x_qm_scale")
    br.expect(3, 2, "b_qm_scale")
    if br.read_u32(_PASSES) != 1:
        raise ParseFault("more than one pass")
    crop = None
    if br.read(1):
        x0 = _unpack(br.read_u32(_FRAME_SIZE))
        y0 = _unpack(br.read_u32(_FRAME_SIZE))
        crop = (x0, y0, br.read_u32(_FRAME_SIZE), br.read_u32(_FRAME_SIZE))
    if br.read_u32(_BLEND_MODE) != 0:
        raise ParseFault("blend mode other than replace")
    if crop is not None:
        br.expect(2, 0, "blend source")
    is_last = br.read(1)
    if is_last != (ftype == 0):
        raise ParseFault("a last frame that is not regular, or the reverse")
    if not is_last:
        br.expect(2, 0, "save_as_reference")
    if br.read_u32(_NAME_LEN) != 0:
        raise ParseFault("frame name")
    br.expect(1, 0, "restoration all_default")
    br.expect(1, 0, "gaborish")
    br.expect(2, 0, "EPF iterations")
    if br.read_u64() != 0 or br.read_u64() != 0:
        raise ParseFault("restoration or frame extensions")
    return crop, bool(is_last)


def _read_toc(br: BitReader, entries: int):
    perm = list(range(entries))
    if br.read(1):
        dec = EntropyDecoder(br, 8)
        dec.begin()
        ctx = lambda v: min(7, _ceil_log2(v + 1))
        end = dec.value(ctx(entries))
        if end > entries:
            raise ParseFault("TOC permutation longer than the TOC")
        lehmer = [0] * entries
        for i in range(end):
            lehmer[i] = dec.value(ctx(lehmer[i - 1] if i else 0))
            if lehmer[i] >= entries - i:
                raise ParseFault("TOC Lehmer code out of range")
        dec.end("TOC permutation")
        left = list(range(entries))
        perm = [left.pop(k) for k in lehmer]
    br.zero_pad()
    sizes = [br.read_u32(_TOC) for _ in range(entries)]
    br.zero_pad()
    return perm, sizes


def _read_tree(br: BitReader, predictor: int, what: str) -> None:
    """An MA tree that must be one leaf with this predictor, offset 0 and
    multiplier 1 (the encoder's fixed trees)."""
    dec = EntropyDecoder(br, 6)
    dec.begin()
    if dec.value(1) != 0:
        raise ParseFault(f"{what}: MA tree is not a single leaf")
    leaf = (dec.value(2), dec.value(3), dec.value(4), dec.value(5))
    dec.end(f"{what} MA tree")
    if leaf != (predictor, 0, 0, 0):
        raise ParseFault(f"{what}: MA leaf {leaf}")


def _modular_values(br: BitReader, predictor: int, count: int, width: int,
                    what: str) -> list:
    br.expect(1, 0, f"{what} use_global_tree")
    br.expect(1, 1, f"{what} weighted predictor defaults")
    if br.read_u32(_NUM_TRANSFORMS) != 0:
        raise ParseFault(f"{what}: modular transforms")
    _read_tree(br, predictor, what)
    dec = EntropyDecoder(br, 1, dist_multiplier=width)
    dec.begin()
    vals = [dec.value(0) for _ in range(count)]
    dec.end(what)
    return vals


class _Frame:
    """Reads the sections of one frame into the image's arrays."""

    def __init__(self, out: Coefficients, x0: int, y0: int, fw: int,
                 fh: int) -> None:
        if x0 % 8 or y0 % 8:
            raise ParseFault("frame origin off the block grid")
        self.out, self.bx0, self.by0 = out, x0 // 8, y0 // 8
        self.vw, self.vh = (fw + 7) // 8, (fh + 7) // 8
        if self.by0 + self.vh > out.lf.shape[0] or \
                self.bx0 + self.vw > out.lf.shape[1]:
            raise ParseFault("frame outside the image")
        self.gx, self.gy = (fw + 255) // 256, (fh + 255) // 256
        self.lgx, self.lgy = (fw + 2047) // 2048, (fh + 2047) // 2048
        self.block_ctx = None
        self.hf_dec = None
        self.num_presets = 0

    def lf_global(self, br: BitReader) -> None:
        br.expect(1, 1, "LF dequantization all_default")
        if br.read_u32(_GLOBAL_SCALE) != T.GLOBAL_SCALE:
            raise ParseFault("global scale")
        if br.read_u32(_QUANT_LF) != T.QUANT_LF:
            raise ParseFault("quant LF")
        br.expect(1, 0, "block context map all_default")
        br.expect(16, 0, "block context thresholds")
        if not br.read(1):
            raise ParseFault("block context map is not a simple map")
        nbits = br.read(2)
        cmap = [br.read(nbits) for _ in range(39)]
        n = max(cmap) + 1
        if sorted(set(cmap)) != list(range(n)):
            raise ParseFault("block context map skips a context")
        # emission order Y, X, B; the map is indexed by (c < 2 ? c ^ 1 :
        # 2) * 13 + transform order (DCT8: 0)
        self.block_ctx = (cmap[0], cmap[13], cmap[26])
        self.num_block_ctx = n
        br.expect(1, 1, "LF channel correlation all_default")
        br.expect(1, 0, "global MA tree")

    def lf_group(self, br: BitReader, idx: int) -> None:
        ly, lx = divmod(idx, self.lgx)
        by, bx = ly * 256, lx * 256
        vh, vw = min(256, self.vh - by), min(256, self.vw - bx)
        br.expect(2, 0, "LF extra precision")
        n = vh * vw
        res = _modular_values(br, GRADIENT, 3 * n, vw, "LF coefficients")
        q = np.empty((3, vh, vw), np.int64)
        for ch in range(3):          # Y, X, B
            plane = [_unpack(v) for v in res[ch * n:(ch + 1) * n]]
            out = [0] * n
            for y in range(vh):
                r = y * vw
                for x in range(vw):
                    if x and y:
                        w, nn, nw = out[r + x - 1], out[r - vw + x], \
                            out[r - vw + x - 1]
                        p = w + nn - nw
                        lo, hi = (w, nn) if w < nn else (nn, w)
                        p = lo if p < lo else hi if p > hi else p
                    elif x:
                        p = out[r + x - 1]
                    elif y:
                        p = out[r - vw]
                    else:
                        p = 0
                    out[r + x] = plane[r + x] + p
            q[ch] = np.array(out, np.int64).reshape(vh, vw)
        gy0, gx0 = self.by0 + by, self.bx0 + bx
        self.out.lf[gy0:gy0 + vh, gx0:gx0 + vw] = q[[1, 0, 2]].transpose(
            1, 2, 0)
        # HF metadata: count, then cfl maps, block types, quant field,
        # sharpness
        count = br.read(_ceil_log2(n)) + 1
        if count != n:
            raise ParseFault("HF metadata block count")
        cfl = 2 * ((vh + 7) // 8) * ((vw + 7) // 8)
        meta = _modular_values(br, ZERO, cfl + 3 * n, n, "HF metadata")
        want = [0] * (cfl + n) + [2 * (T.HF_MULT - 1)] * n + [0] * n
        if meta != want:
            raise ParseFault("HF metadata other than DCT8 blocks at the "
                             "fixed quant field, no CfL, no sharpness")

    def hf_global(self, br: BitReader) -> None:
        br.expect(1, 1, "default dequantization matrices")
        self.num_presets = br.read(_ceil_log2(self.gx * self.gy)) + 1
        if br.read_u32(_USED_ORDERS) != 0:
            raise ParseFault("custom coefficient orders")
        per = self.num_block_ctx * (T.NONZERO_BUCKETS
                                    + T.ZERO_DENSITY_CONTEXTS)
        self.hf_dec = EntropyDecoder(br, per * self.num_presets)
        if self.hf_dec.lz77:
            raise ParseFault("LZ77 in the HF coefficient stream")

    def hf_group(self, br: BitReader, idx: int) -> None:
        gy, gx = divmod(idx, self.gx)
        by, bx = gy * 32, gx * 32
        gbh, gbw = min(32, self.vh - by), min(32, self.vw - bx)
        preset = br.read(_ceil_log2(self.num_presets))
        if preset >= self.num_presets:
            raise ParseFault("histogram preset")
        dec = self.hf_dec
        dec.br = br
        dec.begin()
        nbc = self.num_block_ctx
        per = nbc * (T.NONZERO_BUCKETS + T.ZERO_DENSITY_CONTEXTS)
        base = preset * per
        idx_out, val_out = [], []
        vw_img = self.out.lf.shape[1]
        state = dec.state
        cmap, ans, cfg = dec.cmap, dec.ans, dec.cfg
        buf, pos = br.buf, br.pos
        nzc_t, freq_t = T.COEFF_NUM_NONZERO_CONTEXT, T.COEFF_FREQ_CONTEXT

        def value(ctx):
            nonlocal state, pos
            cl = cmap[ctx]
            sym_l, freq_l, off_l = ans[cl]
            r = state & 0xFFF
            tok = sym_l[r]
            state = freq_l[r] * (state >> 12) + off_l[r]
            if state < 0x10000:
                state = (state << 16) | ((int.from_bytes(
                    buf[pos >> 3:(pos >> 3) + 8], "little") >> (pos & 7))
                    & 0xFFFF)
                pos += 16
            se, msb, lsb = cfg[cl]
            if tok < (1 << se):
                return tok
            nb = se - msb - lsb + ((tok - (1 << se)) >> (msb + lsb))
            low = tok & ((1 << lsb) - 1)
            t = tok >> lsb
            bits = (int.from_bytes(buf[pos >> 3:(pos >> 3) + 8], "little")
                    >> (pos & 7)) & ((1 << nb) - 1)
            pos += nb
            return ((((1 << msb) | (t & ((1 << msb) - 1))) << nb
                     | bits) << lsb) | low

        top = [[0] * gbw for _ in range(3)]
        for y in range(gbh):
            cur = [[0] * gbw for _ in range(3)]
            for x in range(gbw):
                flat = ((self.by0 + by + y) * vw_img
                        + self.bx0 + bx + x) * 192
                for e, c in ((0, 1), (1, 0), (2, 2)):
                    if y == 0:
                        pred = cur[e][x - 1] if x else 32
                    elif x == 0:
                        pred = top[e][0]
                    else:
                        pred = (top[e][x] + cur[e][x - 1] + 1) >> 1
                    bc = self.block_ctx[e]
                    nctx = pred if pred < 8 else 4 + (min(pred, 64) >> 1)
                    nz = value(base + nctx * nbc + bc)
                    if nz > 63:
                        raise ParseFault("more than 63 nonzero coefficients")
                    cur[e][x] = nz
                    if not nz:
                        continue
                    hoff = base + nbc * T.NONZERO_BUCKETS \
                        + T.ZERO_DENSITY_CONTEXTS * bc
                    prev = 0 if nz > 4 else 1
                    k = 1
                    while nz and k < 64:
                        u = value(hoff + ((nzc_t[nz] + freq_t[k]) << 1)
                                  + prev)
                        if u:
                            idx_out.append(flat + k * 3 + c)
                            val_out.append(-((u + 1) >> 1) if u & 1
                                           else u >> 1)
                            nz -= 1
                            prev = 1
                        else:
                            prev = 0
                        k += 1
                    if nz:
                        raise ParseFault("a block ends with nonzeros left")
            top = cur
        br.pos = pos
        dec.state = state
        dec.end("HF group")
        if idx_out:
            self.out.hf.reshape(-1)[np.array(idx_out, np.int64)] = val_out


def decode(data: bytes) -> Coefficients:
    size = len(data)
    data = padded(data)
    br = BitReader(data)
    width, height = _read_image_header(br)
    vh, vw = (height + 7) // 8, (width + 7) // 8
    out = Coefficients(width, height, 0, np.zeros((vh, vw, 3), np.int32),
                       np.zeros((vh, vw, 64, 3), np.int32))
    covered = np.zeros((vh, vw), np.int32)
    while True:
        crop, is_last = _read_frame_header(br)
        x0, y0, fw, fh = crop if crop else (0, 0, width, height)
        fr = _Frame(out, x0, y0, fw, fh)
        ngroups, nlf = fr.gx * fr.gy, fr.lgx * fr.lgy
        entries = 1 if ngroups == 1 else 2 + nlf + ngroups
        perm, sizes = _read_toc(br, entries)
        start = br.pos >> 3
        offs = [0]
        for s in sizes:
            offs.append(offs[-1] + s)

        def section(logical):
            p = perm[logical]
            return BitReader(data, start + offs[p], start + offs[p + 1])

        def close(sbr, what):
            sbr.check_end(what)
            sbr.zero_pad()
            if sbr.pos != sbr.end:
                raise ParseFault(f"{what}: {(sbr.end - sbr.pos) // 8} bytes "
                                 "past its content")

        if entries == 1:
            sbr = section(0)
            fr.lf_global(sbr)
            fr.lf_group(sbr, 0)
            fr.hf_global(sbr)
            fr.hf_group(sbr, 0)
            close(sbr, "frame section")
        else:
            sbr = section(0)
            fr.lf_global(sbr)
            close(sbr, "LF global")
            for i in range(nlf):
                sbr = section(1 + i)
                fr.lf_group(sbr, i)
                close(sbr, f"LF group {i}")
            sbr = section(1 + nlf)
            fr.hf_global(sbr)
            close(sbr, "HF global")
            for g in range(ngroups):
                sbr = section(2 + nlf + g)
                fr.hf_group(sbr, g)
                close(sbr, f"HF group {g}")
        covered[fr.by0:fr.by0 + fr.vh, fr.bx0:fr.bx0 + fr.vw] += 1
        out.frames += 1
        br = BitReader(data, start + offs[-1])
        if start + offs[-1] > size:
            raise ParseFault("a frame's sections run past the file")
        if is_last:
            break
    if br.pos >> 3 != size:
        raise ParseFault(f"{size - (br.pos >> 3)} bytes after the last "
                         "frame")
    if covered.min() != 1 or covered.max() != 1:
        raise ParseFault("frames do not cover the image exactly once")
    return out
