"""ctypes bindings for the port's native serialization plane
(csrc/host/serializer.cc, a copy of the JAX package's cpp/serializer.cc).

Builds build/torch_host/libhydtpu.so with g++ on first use, under a file
lock: processes that start together on a checkout without build/ (test
workers, several encoders) then build once, and the others wait and
load the finished library.  Each build writes a temporary file of its
own and renames it into place, and leaves the hash of its source and
flags beside it (libhydtpu.so.hash): a library built from another
source is rebuilt, whatever the files' times say.  Every class here duck-types its
pure-Python twin in bitwriter.py / entropy.py so the header/frame code
runs unchanged on either plane.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from typing import List, Optional, Sequence

import numpy as np

from .bitwriter import U32Table, ENUM_TABLE

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_PATH = os.path.join(_PKG, "csrc", "host", "serializer.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_host")
_SO_PATH = os.path.join(_BUILD_DIR, "libhydtpu.so")
_HASH_PATH = _SO_PATH + ".hash"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib = None
_load_error: Optional[str] = None


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC_PATH, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def _stale() -> bool:
    """True when the library is missing or was built from another source
    or with other flags (no hash file counts as another source)."""
    try:
        with open(_HASH_PATH) as f:
            built_from = f.read().strip()
    except OSError:
        return True
    return not os.path.exists(_SO_PATH) or built_from != _source_hash()


def _build() -> None:
    """Build the library if it is missing or stale, with
    build/torch_host/.lock held so that one process builds at a time."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():
            return
        tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", *GXX_FLAGS, _SRC_PATH, "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, _SO_PATH)
            with open(tmp, "w") as f:
                f.write(_source_hash())
            os.replace(tmp, _HASH_PATH)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        _build()
        lib = ctypes.CDLL(_SO_PATH)
        P = ctypes.c_void_p
        lib.hyd_writer_new.restype = P
        lib.hyd_writer_free.argtypes = [P]
        lib.hyd_writer_bit_size.restype = ctypes.c_long
        lib.hyd_writer_bit_size.argtypes = [P]
        lib.hyd_writer_write.argtypes = [P, ctypes.c_uint64, ctypes.c_int]
        lib.hyd_writer_zero_pad.argtypes = [P]
        lib.hyd_writer_copy.restype = ctypes.c_long
        lib.hyd_writer_copy.argtypes = [
            P, P, ctypes.c_long, ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int)]
        lib.hyd_writer_append.argtypes = [P, P]
        lib.hyd_writer_append_bytes.argtypes = [P, ctypes.c_char_p,
                                                ctypes.c_long]
        lib.hyd_stream_new.restype = P
        lib.hyd_stream_new.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_uint32, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.hyd_stream_free.argtypes = [P]
        lib.hyd_stream_send.argtypes = [P, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_long]
        lib.hyd_stream_send_mono.argtypes = [P, ctypes.c_uint32,
                                             ctypes.c_void_p, ctypes.c_long]
        lib.hyd_stream_prefix_finalize.restype = ctypes.c_int
        lib.hyd_stream_prefix_finalize.argtypes = [P, P]
        lib.hyd_hf_new.restype = P
        lib.hyd_hf_new.argtypes = [ctypes.c_long]
        lib.hyd_hf_free.argtypes = [P]
        lib.hyd_hf_add_group.argtypes = [P] + [ctypes.c_void_p] * 5 + [
            ctypes.c_long, ctypes.c_uint32]
        lib.hyd_hf_add_lfg_packed.restype = ctypes.c_int
        lib.hyd_hf_add_lfg_packed.argtypes = [
            P, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.hyd_hf_prepare.restype = ctypes.c_int
        lib.hyd_hf_prepare.argtypes = [P]
        lib.hyd_hf_encode_all.restype = ctypes.c_int
        lib.hyd_hf_encode_all.argtypes = [P, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_void_p),
                                          ctypes.c_int]
        lib.hyd_hf_write_header.restype = ctypes.c_int
        lib.hyd_hf_write_header.argtypes = [P, ctypes.c_char_p,
                                            ctypes.c_long, P]
        lib.hyd_hf_num_groups.restype = ctypes.c_long
        lib.hyd_hf_num_groups.argtypes = [P]
        lib.hyd_hf_num_symbols.restype = ctypes.c_long
        lib.hyd_hf_num_symbols.argtypes = [P]
        lib.hyd_hf_force_las.argtypes = [P, ctypes.c_int]
        lib.hyd_hf_las.restype = ctypes.c_int
        lib.hyd_hf_las.argtypes = [P]
        lib.hyd_hf_frequencies.restype = ctypes.c_long
        lib.hyd_hf_frequencies.argtypes = [P, ctypes.c_long, ctypes.c_void_p,
                                           ctypes.c_long]
        lib.hyd_lf_decode.restype = ctypes.c_long
        lib.hyd_lf_decode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_long, ctypes.c_long,
                                      ctypes.c_void_p]
        lib.hyd_tok_build_tables.restype = ctypes.c_int
        lib.hyd_tok_build_tables.argtypes = [ctypes.c_void_p] * 4
        lib.hyd_png_unfilter.restype = ctypes.c_int
        lib.hyd_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_long, ctypes.c_int,
                                         ctypes.c_int]
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as e:
        # no g++, a failed build or an unwritable build/: no native plane
        _load_error = str(e)
    return _lib


def available() -> bool:
    return _load() is not None


def png_unfilter(cur: np.ndarray, prev: Optional[np.ndarray], bpp: int,
                 filt: int) -> None:
    """Reconstruct one PNG scanline in place (spec 9.2): cur is the
    filtered row (u8, contiguous, the filter byte stripped), prev the
    reconstructed row above it or None.  Raises on an unknown filter."""
    ret = _load().hyd_png_unfilter(
        cur.ctypes.data, None if prev is None else prev.ctypes.data,
        cur.size, bpp, filt)
    if ret != 0:
        raise ValueError(f"bad PNG filter {filt}")


def tok_build_tables(freqs: np.ndarray):
    """The transport code's tables from freqs [10, 64] (jxl/tokcode.py
    build_tables' twin, element for element): (lengths i32[640],
    codewords u32[640], decode LUTs u16[10, 4096]).  The build runs
    without the GIL.  Raises RuntimeError for a negative frequency."""
    f = np.ascontiguousarray(freqs, np.int64).reshape(10, 64)
    lens = np.empty(640, np.int32)
    codes = np.empty(640, np.uint32)
    lut = np.empty((10, 4096), np.uint16)
    if _load().hyd_tok_build_tables(f.ctypes.data, lens.ctypes.data,
                                    codes.ctypes.data, lut.ctypes.data):
        raise RuntimeError("native transport code build failed")
    return lens, codes, lut


def lf_decode(words: np.ndarray, lf_lut: np.ndarray, lf_n: int,
              total_bits: int) -> Optional[np.ndarray]:
    """Decode the format-v4 LF residual stream (bit-contiguous hybrid-
    uint fields under the class-9 transport code) into lf_n pack_signed
    residuals.  words must extend at least one word past the stream
    (fetches carry +1 slack).  lf_lut: u16[4096] decode LUT
    (jxl/tokcode.py row LF_CLASS).  None when the decoded stream does
    not land exactly on total_bits (corrupt payload)."""
    lib = _load()
    w = np.ascontiguousarray(words, np.uint32)
    lut = np.ascontiguousarray(lf_lut, np.uint16)
    assert lut.size == 4096
    out = np.empty(lf_n, np.uint32)
    end = lib.hyd_lf_decode(w.ctypes.data, lut.ctypes.data, lf_n,
                            total_bits, out.ctypes.data)
    if end != total_bits:
        return None
    return out


class NativeBitWriter:
    """Drop-in replacement for jxl.bitwriter.BitWriter backed by C++."""

    __slots__ = ("_h", "_lib")

    def __init__(self) -> None:
        self._lib = _load()
        self._h = self._lib.hyd_writer_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hyd_writer_free(self._h)
            self._h = None

    def write(self, value: int, bits: int) -> None:
        if bits <= 0:
            return
        while bits > 56:
            self._lib.hyd_writer_write(self._h, value & (1 << 56) - 1, 56)
            value >>= 56
            bits -= 56
        self._lib.hyd_writer_write(self._h, value, bits)

    def write_bool(self, flag: bool) -> None:
        self._lib.hyd_writer_write(self._h, 1 if flag else 0, 1)

    def write_u32(self, table: U32Table, value: int) -> None:
        for i in range(4):
            vmc = value - table.cpos[i]
            if 0 <= vmc <= (1 << table.upos[i]) - 1:
                self.write((vmc << 2) | i, table.upos[i] + 2)
                return
        raise ValueError(f"value {value} not encodable")

    def write_enum(self, value: int) -> None:
        self.write_u32(ENUM_TABLE, value)

    def write_u64(self, value: int) -> None:
        if value == 0:
            self.write(0, 2)
            return
        if value < 17:
            self.write(((value - 1) << 2) | 1, 6)
            return
        if value < 273:
            self.write(((value - 17) << 2) | 2, 10)
            return
        self.write(((value & 0xFFF) << 2) | 3, 14)
        shift = 12
        while True:
            svalue = value >> shift
            if svalue == 0:
                self.write(0, 1)
                return
            if shift == 60:
                self.write(((svalue & 0xF) << 1) | 1, 5)
                return
            self.write(((svalue & 0xFF) << 1) | 1, 9)
            shift += 8

    def write_icc_varint(self, value: int) -> None:
        while value > 0x7F:
            self.write((value & 0x7F) | 0x80, 8)
            value >>= 7
        self.write(value & 0x7F, 8)

    def zero_pad(self) -> None:
        self._lib.hyd_writer_zero_pad(self._h)

    @property
    def bit_position(self) -> int:
        return self._lib.hyd_writer_bit_size(self._h)

    def __len__(self) -> int:
        return self.bit_position // 8

    def append_bytes(self, data: bytes) -> None:
        self._lib.hyd_writer_append_bytes(self._h, data, len(data))

    def append_writer(self, other: "NativeBitWriter") -> None:
        self._lib.hyd_writer_append(self._h, other._h)

    def finalize(self) -> bytes:
        self.zero_pad()
        n = len(self)
        buf = ctypes.create_string_buffer(n)
        tail_val = ctypes.c_uint32(0)
        tail_bits = ctypes.c_int(0)
        got = self._lib.hyd_writer_copy(self._h, buf, n,
                                        ctypes.byref(tail_val),
                                        ctypes.byref(tail_bits))
        assert got == n and tail_bits.value == 0
        return buf.raw

    def export_raw(self):
        """(whole_bytes, tail_value, tail_bits) without padding -- for
        spooling unaligned sections to disk."""
        n = len(self)
        buf = ctypes.create_string_buffer(max(n, 1))
        tail_val = ctypes.c_uint32(0)
        tail_bits = ctypes.c_int(0)
        got = self._lib.hyd_writer_copy(self._h, buf, n,
                                        ctypes.byref(tail_val),
                                        ctypes.byref(tail_bits))
        assert got == n
        return buf.raw[:n], tail_val.value, tail_bits.value


class NativeStream:
    """Send-based entropy stream (prefix path) backed by C++."""

    __slots__ = ("_h", "_lib")

    def __init__(self, cluster_map: Sequence[int], num_dists: int,
                 custom_config=None, lz77_min_symbol: int = 0,
                 modular: bool = False) -> None:
        self._lib = _load()
        cm = bytes(cluster_map[:num_dists])
        cfg = custom_config or (0, 0, 0)
        self._h = self._lib.hyd_stream_new(
            cm, num_dists, lz77_min_symbol, 1 if modular else 0,
            1 if custom_config else 0, cfg[0], cfg[1], cfg[2])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hyd_stream_free(self._h)
            self._h = None

    def send_mono(self, dist: int, symbols: np.ndarray) -> None:
        symbols = np.ascontiguousarray(symbols, dtype=np.uint32)
        self._lib.hyd_stream_send_mono(self._h, dist, symbols.ctypes.data,
                                       len(symbols))

    def send(self, dists: np.ndarray, symbols: np.ndarray) -> None:
        dists = np.ascontiguousarray(dists, dtype=np.uint32)
        symbols = np.ascontiguousarray(symbols, dtype=np.uint32)
        self._lib.hyd_stream_send(self._h, dists.ctypes.data,
                                  symbols.ctypes.data, len(symbols))

    def prefix_finalize(self, bw: NativeBitWriter) -> None:
        ret = self._lib.hyd_stream_prefix_finalize(self._h, bw._h)
        if ret != 0:
            raise RuntimeError("native prefix finalize failed")


class NativeHF:
    """HF ANS batch encoder backed by C++ (threaded across groups)."""

    __slots__ = ("_h", "_lib", "_keepalive")

    def __init__(self, num_clusters: int) -> None:
        self._lib = _load()
        self._h = self._lib.hyd_hf_new(num_clusters)
        self._keepalive: List[np.ndarray] = []

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hyd_hf_free(self._h)
            self._h = None

    def add_group(self, tokens: np.ndarray, clusters: np.ndarray,
                  residues: np.ndarray, residue_bits: np.ndarray,
                  valid_len: np.ndarray, preset: int) -> None:
        """Arrays shaped [n_blocks, 3, 64] (+ valid_len [n_blocks, 3])."""
        t = np.ascontiguousarray(tokens, np.uint16)
        c = np.ascontiguousarray(clusters, np.uint8)
        r = np.ascontiguousarray(residues, np.uint32)
        b = np.ascontiguousarray(residue_bits, np.uint8)
        v = np.ascontiguousarray(valid_len, np.int32)
        n_blocks = t.size // (3 * 64)
        self._lib.hyd_hf_add_group(self._h, t.ctypes.data, c.ctypes.data,
                                   r.ctypes.data, b.ctypes.data,
                                   v.ctypes.data, n_blocks, preset)

    def add_lfg_packed(self, tok_words: np.ndarray, res_words: np.ndarray,
                       tok_lut: np.ndarray, cluster_map: np.ndarray,
                       preset: int, grid, extent,
                       tok_bit_offs: np.ndarray, res_bit_offs: np.ndarray,
                       sym_counts: np.ndarray, n_threads: int = 0) -> None:
        """Walk every group of one LF group in parallel (payload format
        v3/v4; threads write disjoint symbol ranges sized by the device's
        per-group counts).  grid = (gcy, gcx) buffer group grid; extent
        = (vh, vw) true varblock extent.  tok_lut: u16[n_classes, 4096]
        per-cluster transport-Huffman decode LUTs (jxl/tokcode.py);
        class = cluster % n_classes."""
        t = np.ascontiguousarray(tok_words, np.uint32)
        r = np.ascontiguousarray(res_words, np.uint32)
        lut = np.ascontiguousarray(tok_lut, np.uint16)
        tok_classes = lut.size // 4096
        cm = np.ascontiguousarray(cluster_map, np.uint8)
        to = np.ascontiguousarray(tok_bit_offs, np.int64)
        ro = np.ascontiguousarray(res_bit_offs, np.int64)
        sc = np.ascontiguousarray(sym_counts, np.int64)
        gcy, gcx = grid
        vh, vw = extent
        assert len(sc) == gcy * gcx
        if n_threads <= 0:
            n_threads = min(os.cpu_count() or 1, 8)
        ret = self._lib.hyd_hf_add_lfg_packed(
            self._h, t.ctypes.data, r.ctypes.data, lut.ctypes.data,
            tok_classes, cm.ctypes.data, preset, gcy, gcx, vh, vw,
            to.ctypes.data, ro.ctypes.data, sc.ctypes.data, n_threads)
        if ret != 0:
            # the C++ side rolls its symbol array back on failure, so
            # this HydHF remains usable and the caller may retry
            raise RuntimeError(
                "packed walk failed (symbol-count mismatch / corrupt stream)")

    def prepare(self) -> None:
        if self._lib.hyd_hf_prepare(self._h) != 0:
            raise RuntimeError("native hf prepare failed")

    def encode_all(self, preset_bits: int,
                   n_threads: int = 0) -> List[NativeBitWriter]:
        """Every group's section, on up to n_threads threads (0: the
        host's cores, at most 16); the C++ side starts no more threads
        than there are groups, so a one-group frame encodes on the
        calling thread."""
        n = self._lib.hyd_hf_num_groups(self._h)
        writers = [NativeBitWriter() for _ in range(n)]
        arr = (ctypes.c_void_p * n)(*[w._h for w in writers])
        if n_threads <= 0:
            n_threads = min(os.cpu_count() or 1, 16)
        if self._lib.hyd_hf_encode_all(self._h, preset_bits, arr,
                                       n_threads) != 0:
            raise RuntimeError("native hf encode failed")
        return writers

    def write_header(self, cluster_map: np.ndarray,
                     bw: NativeBitWriter) -> None:
        cm = np.ascontiguousarray(cluster_map, np.uint8).tobytes()
        if self._lib.hyd_hf_write_header(self._h, cm, len(cm), bw._h) != 0:
            raise RuntimeError("native hf header failed")

    def force_las(self, las: int) -> None:
        self._lib.hyd_hf_force_las(self._h, las)

    @property
    def las(self) -> int:
        return self._lib.hyd_hf_las(self._h)

    @property
    def num_symbols(self) -> int:
        """The symbols added, which encode_all encodes."""
        return self._lib.hyd_hf_num_symbols(self._h)

    def frequencies(self, cluster: int, cap: int = 512) -> np.ndarray:
        out = np.zeros(cap, np.uint32)
        n = self._lib.hyd_hf_frequencies(self._h, cluster, out.ctypes.data,
                                         cap)
        if n < 0:
            raise RuntimeError("frequencies buffer too small")
        return out[:n]
