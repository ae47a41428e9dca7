"""Streaming encoder on a PyTorch device or on the host's numpy plane,
in one-frame and tiled mode.

Two math planes, as hydrium_tpu has (Encoder(backend=...) or
Encoder(profile=...)):
- "torch" (profile "fast", the default): the device plane below;
- "numpy" (profile "conformance"): the fixed-point/LUT twin of the
  reference encoder (ops/reference.py, ops/hf_tokens.py), byte-identical
  to hydrium_tpu's backend="numpy".  It runs on the host alone: no
  device, no codec, no worker threads; it uses the native serialization
  plane when that builds and its pure-Python twin when it does not.

The device plane is the device half of hydrium_tpu's jax backend,
ported: each LF group (in tiled mode: each tile, or a stack of
full-size tiles) runs the packed
pipeline (ops/packed.py) on the device, the host copies back the aux
prefix and then exactly the stream words it needs, and the port's own
host plane (host.py's payload parser, the C++ walker, ANS, frame/TOC
assembly, streaming output; copies of hydrium_tpu's) does the rest.
The frame assembly and the tiled-mode unit bookkeeping follow
hydrium_tpu.encoder.Encoder's, so the output bytes equal
backend="jax"'s.

Preserves the reference's streaming API contract (libhydrium.h:165-314):
metadata first, then tiles in any order (`send_tile`), encoded bytes
drained incrementally (`take_output`).  In one-frame mode the device
plane streams every multi-group frame (per-preset ANS as each preset's
last LF group arrives, sections spooled), as the jax backend does; the
numpy plane does so from Encoder.STREAMING_LFG_THRESHOLD LF groups up,
as the numpy backend does.

Dispatch and drain overlap.  A dispatch copies its pixels into a
pinned staging buffer and returns; one of two prep workers ("hyd-prep",
process-wide) uploads them and enqueues the packed pipeline, as
hydrium_tpu's dispatch-preparation pool does (on a card by replaying the
CUDA graph of the dispatch's static key, ops/graphs.py, as hydrium_tpu
runs one jitted executable per key); its payload comes back on
a thread of its own ("hyd-fetch": the aux prefix first, then
exactly the stream words it names, each into a pinned buffer behind a
CUDA event).  One-frame mode keeps HYDRIUM_INFLIGHT (default 3) LF
groups in flight and walks them on one ordered drain worker; tiled mode
fetches every unit on its own thread and keeps two units across calls.
With device="cpu" the same threads run with plain copies.  An error on
a worker thread (a checksum mismatch, a failed enqueue) reaches the
caller from send_tile, send_tile_batch or the call that finalizes.
Stage "dispatch" times the caller's share of a dispatch, stage
"prepare" the prep workers' (summed over threads).  Every span of a
dispatch is tagged with its LF group's (or tile unit's) (y, x), on each
thread that serves it (utils/stats.py): the code tables, the fetch's
waits and codec fold, the drain's wait, parse and walk, the renders.

The device plane requires the native serialization plane (the packed
path is where the device kernels are).  Its transport code is one per
process, shared by every Encoder and persisted when an encode finishes
(~/.cache/hydrium_tpu_torch/warm.npz, or $HYDRIUM_TORCH_WARM_CACHE); a
cold one bootstraps from the first dispatch's histogram.  It changes
payload size, never output bytes.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from . import host as _host
from .config import ImageMetadata, SampleFormat
from .device import resolve_device
from .jxl import headers, native
from .jxl.bitwriter import BitWriter
from .jxl.frame import (HF_GLOBAL_KEY, HF_GROUPS_KEY, FrameGeometry,
                        FrameSections, HFStream, LFGroupGeometry,
                        StreamingHFStream, new_bitwriter, one_frame_geometry,
                        write_frame_header, write_lf_global, write_lf_group)
from .jxl.tokcode import LF_CLASS, TokenCodec
from .models import get_profile
from .ops import front as _front
from .ops import graphs as _graphs
from .ops import packed as _packed
from .ops import reference as np_ops
from .ops.constants import packed_aux_len
from .ops.frontend import default_fused
from .ops.hf_tokens import tokenize_group
from .utils.stats import EncodeStats

# the math planes: the PyTorch device plane, and the numpy conformance
# plane (hydrium_tpu's backend="numpy", whose default it is there)
_BACKENDS = ("torch", "numpy")


def _lfg_numpy(pixels, sample_fmt, linear_light, lfg, preset, hf):
    """Numpy conformance backend: computes, tokenizes, and feeds the HF
    stream; returns (lf_q, lf_res_packed_or_None)."""
    xyb = np_ops.pixels_to_xyb(pixels, sample_fmt, linear_light)
    xyb = np_ops.pad_to_blocks(xyb, lfg.height, lfg.width)
    coeffs = np_ops.forward_dct(xyb)
    zz = np_ops.zigzag_gather(coeffs)
    hf_q, nz = np_ops.quantize_hf(zz)
    lf_q = np_ops.quantize_lf(coeffs[:, :, 0, 0, :])
    for gy, gx, gh, gw in lfg.groups():
        gb = (slice(gy * 32, gy * 32 + ((gh + 7) >> 3)),
              slice(gx * 32, gx * 32 + ((gw + 7) >> 3)))
        tok = tokenize_group(hf_q[gb], nz[gb], preset, hf.cluster_map)
        hf.add_group_padded(tok.tokens, tok.clusters, tok.residues,
                            tok.residue_bits, tok.valid_len, preset)
    return lf_q, None


_SHARED_CODEC: Optional[TokenCodec] = None
_WARM_CACHE = (os.environ.get("HYDRIUM_TORCH_WARM_CACHE")
               or os.path.expanduser("~/.cache/hydrium_tpu_torch/warm.npz"))
# (buf_h, buf_w, sample format) of buffers whose content needed the wide
# residue geometry: later dispatches of that shape skip the doomed
# narrow one (wide output is always valid, a little larger)
_WIDE_HINT: dict = {}
# one dispatch enqueues at a time: re-dispatches (bootstrap, wide retry)
# come from fetch threads, and the kernels' launch counters are plain
# attributes
_DISPATCH_LOCK = threading.Lock()
_BOOTSTRAP_LOCK = threading.Lock()
_FETCH_STREAMS: dict = {}
# dispatch preparation (upload + enqueue, _TorchDispatch._prepare), off
# the caller's thread.  Its own executor, apart from the drain worker,
# the render pool and the fetch threads, which all wait on dispatches:
# nothing that runs here waits on anything queued behind it.
_PREP_POOL: Optional[ThreadPoolExecutor] = None
_PREP_POOL_LOCK = threading.Lock()


def _shared_codec() -> TokenCodec:
    """One adaptive transport codec per process, shared across Encoders:
    the code never affects output bytes, only payload size, and a warm
    code saves ~1 bit/symbol over the generic prior on the first LF
    groups of every later encode.  State persists across processes
    (_WARM_CACHE) -- stale state costs payload size until adaptation
    catches up, never correctness."""
    global _SHARED_CODEC
    if _SHARED_CODEC is None:
        _SHARED_CODEC = TokenCodec(cache_path=_WARM_CACHE)
        _load_warm_hints()
    return _SHARED_CODEC


def _save_warm_state() -> None:
    """Persist the codec and the wide hints (best effort, called when an
    encode finishes), so that a fresh process (a one-shot CLI encode)
    starts with an adapted code and the wide geometry where its content
    needs it."""
    try:
        if _SHARED_CODEC is not None and not _SHARED_CODEC.cold:
            _SHARED_CODEC.save(_WARM_CACHE)
            hints = {"wide": [f"{h}x{w}x{f}" for (h, w, f), v
                              in list(_WIDE_HINT.items()) if v]}
            tmp = f"{_WARM_CACHE}.hints.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(hints, f)
            os.replace(tmp, _WARM_CACHE + ".hints.json")
    except OSError:
        pass            # an unwritable cache costs the next start only


def _load_warm_hints() -> None:
    try:
        with open(_WARM_CACHE + ".hints.json") as f:
            hints = json.load(f)
        for k in hints.get("wide", []):
            h, w, fmt = k.split("x")
            _WIDE_HINT.setdefault((int(h), int(w), fmt), True)
    except (OSError, ValueError):
        pass            # no hints, or unreadable ones, are no hints


def reset_warm_state(cache_path=None) -> None:
    """Forget this process's codec and wide hints; the next Encoder
    loads them again from the cache path, which becomes `cache_path`
    when one is given.  Tests and smoke runs point it at an empty
    temporary directory, so that a cold start is really cold."""
    global _SHARED_CODEC, _WARM_CACHE
    if cache_path is not None:
        _WARM_CACHE = str(cache_path)
    _SHARED_CODEC = None
    _WIDE_HINT.clear()


def _prep_pool() -> ThreadPoolExecutor:
    """The process-wide pool of two "hyd-prep" workers that upload and
    enqueue every dispatch (made at first use)."""
    global _PREP_POOL
    with _PREP_POOL_LOCK:
        if _PREP_POOL is None:
            _PREP_POOL = ThreadPoolExecutor(max_workers=2,
                                            thread_name_prefix="hyd-prep")
        return _PREP_POOL


def _spawn(fn, *args) -> Future:
    """Run fn(*args) on a daemon thread of its own; the Future carries
    its result or its exception to whoever joins it."""
    fut: Future = Future()

    def run():
        try:
            fut.set_result(fn(*args))
        except BaseException as e:      # re-raised on the joining thread
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True, name="hyd-fetch").start()
    return fut


def _fetch_stream(device: torch.device):
    """The side stream (one per card) that the stream words come back
    on, so that a copy does not queue behind later dispatches."""
    s = _FETCH_STREAMS.get(device)
    if s is None:
        # two threads may both make one; the first to land is kept
        s = _FETCH_STREAMS.setdefault(device, torch.cuda.Stream(device))
    return s


def _current(device: torch.device):
    """Make `device` the current card while a dispatch enqueues: the
    kernels launch on the runtime's current device, which must own the
    stream they are given (a no-op on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _HostCopy:
    """A device tensor on its way to the host.  On a card: a
    non-blocking copy on the current stream into a pinned buffer, and an
    event that wait() synchronizes on; the source stays referenced until
    then, so its memory is not handed out again while another stream
    reads it.  On the CPU: the tensor's own memory."""

    def __init__(self, t: torch.Tensor) -> None:
        self._event = None
        if t.device.type == "cuda":
            self._src = t
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = self._src = None
        return self._host.numpy()


def buffer_shapes(lfg) -> tuple:
    """(buf_h, buf_w, ubuf_h, ubuf_w) of a dispatch: 256-multiple
    buffers of the true extent, and the upload bucketed to 32 rows and
    columns (the JAX package's bucketing, so both compute the same
    groups)."""
    h, w = lfg.height, lfg.width
    buf_h = min(lfg.tile_count_y << 8, ((h + 255) >> 8) << 8)
    buf_w = min(lfg.tile_count_x << 8, ((w + 255) >> 8) << 8)
    return (buf_h, buf_w, min(buf_h, ((h + 31) >> 5) << 5),
            min(buf_w, ((w + 31) >> 5) << 5))


class _TorchDispatch:
    """One LF group (or tile, or stack of tiles) on the device.  Making
    one copies the caller's pixels into a pinned staging buffer
    (synchronously: the caller may reuse its buffer at once) and hands
    the upload and the enqueue of the packed pipeline to the prep pool
    (_prepare); start_fetch() brings the payload back on a thread of its
    own; join() waits for it; drain() walks it into the HF stream.
    Whatever touches what _prepare makes joins it first
    (join_prepare), and an error raised there is raised by that join.
    fused selects the fused front; lf_seg_vb > 0 restarts LF prediction
    every lf_seg_vb varblock rows (stacked tiles are independent
    frames).  tag: the (y, x) its spans carry, the LF group's by
    default."""

    def __init__(self, pixels, sample_fmt: str, linear_light: bool, lfg,
                 preset: int, hf, codec: TokenCodec,
                 front: _front.FrontEnd, device: torch.device,
                 stats: EncodeStats, *, fused: bool = False,
                 lf_seg_vb: int = 0, tag: Optional[tuple] = None) -> None:
        h, w = lfg.height, lfg.width
        self.buf_h, self.buf_w, ubuf_h, ubuf_w = buffer_shapes(lfg)
        dtype = torch.from_numpy(np.empty(0, np.asarray(pixels).dtype)).dtype
        # referenced until the fetch is done: the upload from it is
        # asynchronous
        self._stage = torch.zeros((ubuf_h, ubuf_w, 3), dtype=dtype,
                                  pin_memory=device.type == "cuda")
        self._stage.numpy()[:h, :w] = pixels[:h, :w]
        self.lfg, self.preset, self.hf = lfg, preset, hf
        self.codec, self.front, self.device = codec, front, device
        self.stats = stats
        self.tag = (lfg.y, lfg.x) if tag is None else tag
        self.sample_fmt, self.linear_light = sample_fmt, linear_light
        self.fused, self.lf_seg_vb = fused, lf_seg_vb
        self.num_clusters = int(hf.cluster_map.max()) + 1
        self.tok_classes = self.num_clusters // hf.num_presets
        self._wide_key = (self.buf_h, self.buf_w, sample_fmt)
        self.wide = _WIDE_HINT.get(self._wide_key, False)
        self.px = self.presets = None
        self._future: Optional[Future] = None
        self._result = None
        self._prep = _prep_pool().submit(self._prepare)

    def _prepare(self) -> None:
        """On the prep pool: upload the staged pixels, make the presets
        tensor and enqueue the packed pipeline, all on the device's
        current stream of this thread (the one the fetch's events
        order against).  Never submits to the pool: a re-dispatch
        (bootstrap, wide retry) runs on the fetch thread."""
        tag = self.tag
        stage = self._stage
        with self.stats.stage("prepare", tag):
            with self.stats.event("h2d", tag), _DISPATCH_LOCK, \
                    _current(self.device):
                self.px = (stage.to(self.device, non_blocking=True)
                           if self.device.type == "cuda" else stage)
                G = (self.buf_h >> 8) * (self.buf_w >> 8)
                self.presets = torch.full((G,), self.preset,
                                          dtype=torch.int32,
                                          device=self.device)
            self.stats.count("h2d_raw_bytes",
                             stage.numel() * stage.element_size())
            with self.stats.event("dispatch", tag):
                self._dispatch()

    def join_prepare(self) -> None:
        """Wait for _prepare; raises what it raised."""
        self._prep.result()

    def _dispatch(self) -> None:
        """Enqueue the packed pipeline (on a card: replay the graph of
        its key, ops/graphs.py) with a snapshot of the codec, and the
        copy of its aux prefix: the walker must decode with exactly
        the table the device packed with.  The LUT is sliced to this
        frame's class count so the walker's class = cluster %
        (lut.size/4096) matches the device's.  Counts the dispatch, and
        the code tables' build where the codec had none built."""
        self.stats.count("dispatches")
        build = not self.codec.built
        with self.stats.stage("codec_tables", self.tag):
            lens, codes, lut = self.codec.tables()
        if build:
            self.stats.count("codec_table_builds")
        self.tok_lut = lut[:self.tok_classes]
        self.lf_lut = lut[LF_CLASS]
        A = packed_aux_len(self.buf_h, self.buf_w)
        # the code tables go in as the copy of a host array: on a card
        # into the static inputs of the key's graph, from pinned memory
        tables = torch.from_numpy(np.stack([lens, codes]).astype(np.int32))
        if self.device.type == "cuda":
            run, tables = _graphs.encode_lfg_packed, tables.pin_memory()
        else:
            run = _packed.encode_lfg_packed
        with _DISPATCH_LOCK, _current(self.device):
            self._combined = run(
                self.front, self.px, self.lfg.height, self.lfg.width,
                self.presets, tables[0], tables[1],
                buf_h=self.buf_h, buf_w=self.buf_w,
                linear_light=self.linear_light, sample_kind=self.sample_fmt,
                tok_classes=self.tok_classes, wide_residues=self.wide,
                lf_seg_vb=self.lf_seg_vb, fused=self.fused)
            self._aux = _HostCopy(self._combined[:A])
        self.stats.count("fetched_words", A)

    def start_fetch(self) -> None:
        self._future = _spawn(self._fetch)

    def join(self):
        """(aux, words or None) of the fetch, which runs here when no
        thread was started for it; raises what the prepare or the fetch
        raised."""
        if self._result is None:
            self._result = (self._fetch() if self._future is None
                            else self._future.result())
        return self._result

    def _checked_aux(self) -> np.ndarray:
        """Wait for the aux prefix.  A checksum mismatch raises: a local
        card has no lossy link that a refetch could fix."""
        with self.stats.stage("aux_wait", self.tag):
            aux = self._aux.wait()
        if not _host.packed_verify(aux, None):
            raise RuntimeError("packed payload aux checksum mismatch")
        return aux

    def _fetch(self):
        """Bring the payload back: the aux prefix (after the cold-start
        bootstrap and the wide retry where they apply) and, for a valid
        payload, exactly the stream words it needs; the aux histogram
        goes into the codec.  Returns (aux, words or None)."""
        self.join_prepare()
        tag = self.tag
        folded = False
        if self.codec.cold:
            # cold-start bootstrap, once per cold codec: the generic
            # prior costs ~1 b/sym on real content, so wait for the aux
            # prefix only (it holds the per-class histogram), warm the
            # codec and dispatch again with the adapted code before the
            # streams are copied back
            with _BOOTSTRAP_LOCK:
                if self.codec.cold:
                    aux = self._checked_aux()
                    with self.stats.stage("codec_fold", tag):
                        self.codec.update(aux[8:648])
                    folded = True
                    if not self.codec.cold:
                        self._dispatch()
                        self.stats.count("codec_bootstraps")
        while True:
            aux = self._checked_aux()
            if int(aux[0]) == 2 and not self.wide:
                # a residue chunk or field exceeded the fast budget:
                # repack with the wide geometry, now and from here on
                self.wide = _WIDE_HINT[self._wide_key] = True
                self.stats.count("wide_retries")
                self._dispatch()
                continue
            break
        words = None
        if aux[0] & 1:
            A = packed_aux_len(self.buf_h, self.buf_w)
            need = _host.packed_need_words(aux)
            span = self._combined[A:A + need + 1]
            if self.device.type == "cuda":
                # the dispatch is done (its aux prefix arrived)
                with torch.cuda.stream(_fetch_stream(self.device)):
                    copy = _HostCopy(span)
            else:
                copy = _HostCopy(span)
            with self.stats.stage("words_wait", tag):
                words = copy.wait().view(np.uint32)
            self.stats.count("fetched_words", need + 1)
            if not _host.packed_verify(aux, words):
                raise RuntimeError("packed payload stream checksum mismatch")
        if not folded:
            with self.stats.stage("codec_fold", tag):
                self.codec.update(aux[8:648])
        self._combined = self._aux = self._stage = None
        return aux, words

    def drain(self):
        """Join the fetch, then walk into the HF stream.  Returns
        (lf_q, lf_res) for the LF group section (one of them None)."""
        tag = self.tag
        with self.stats.stage("drain_wait", tag):
            aux, words = self.join()
        if words is not None:
            with self.stats.stage("parse", tag):
                parsed = _host._parse_packed(aux, words, self.buf_h,
                                             self.buf_w, self.lfg,
                                             self.lf_lut)
            if parsed is not None:
                with self.stats.stage("walk", tag):
                    _host._feed_hf_packed(self.hf, parsed, self.lfg,
                                          self.buf_w, self.buf_h,
                                          self.preset, self.tok_lut)
                self.stats.count("lfg_packed")
                self.stats.count("walk_symbols", int(parsed["gs"].sum()))
                return None, parsed["lf_res"]
        self.stats.count("lfg_fallback")
        return self._unpacked()

    def _unpacked(self):
        """The unpacked path (a token outside the transport alphabet or
        residues beyond even the wide budget), still on the device."""
        lfg = self.lfg
        with _DISPATCH_LOCK, _current(self.device):
            out = _front.encode_lfg(
                self.front, self.px, lfg.height, lfg.width, self.presets,
                buf_h=self.buf_h, buf_w=self.buf_w,
                linear_light=self.linear_light,
                num_clusters=self.num_clusters,
                sample_kind=self.sample_fmt, lf_seg_vb=self.lf_seg_vb,
                clusters_per_preset=self.tok_classes, fused=self.fused)
        vh, vw = lfg.varblock_height, lfg.varblock_width
        bgcx = self.buf_w >> 8
        G = (self.buf_h >> 8) * bgcx
        host = {k: v.cpu().numpy() for k, v in out.items()}
        self.stats.count("fetched_words",
                         sum(a.nbytes for a in host.values()) // 4)
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


class Encoder:
    """Streaming encoder with hydrium's tile contract.  The API is
    hydrium_tpu.Encoder's: send_tile, send_tile_batch (tiled mode),
    take_output, iter_output, close and set_suggested_icc_profile.

    backend "torch" (the default) is the PyTorch device plane on
    `device` ("cuda" needs a card; "cpu" runs the kernels' plain twins);
    "numpy" is the conformance plane, byte-identical to hydrium_tpu's
    backend="numpy", which ignores `device` and touches no device.
    `profile` ("fast", "conformance" or a models.Profile) sets the
    backend and overrides `backend`.  hydrium_tpu defaults to "numpy";
    this package defaults to its device plane.  fused_front selects the
    fused front (ops/frontend.py); None means as HYDRIUM_PALLAS says,
    which is off unless it is "1".  streaming=False keeps a multi-group
    one-frame encode in RAM and encodes its ANS sections at the end;
    spool_dir spools a streaming encode's sections to disk.  Left to
    itself, the device plane streams every multi-group one-frame encode,
    the numpy plane from STREAMING_LFG_THRESHOLD LF groups up.

    On the device plane, one-frame mode keeps up to HYDRIUM_INFLIGHT
    (default 3, read when the Encoder is made) LF groups in flight
    behind the one being sent; 0 drains each before send_tile returns,
    and in tiled mode drains each unit as soon as it is dispatched.  The
    transport codec is the process's shared one (_shared_codec).

    The positional parameters are hydrium_tpu.Encoder's, in its order
    (metadata, backend, streaming, spool_dir, profile); device and
    fused_front, which it lacks, are keyword-only."""

    # numpy-plane one-frame encodes with at least this many LF groups
    # switch to the memory-bounded streaming HF path (per-preset eager
    # ANS encoding)
    STREAMING_LFG_THRESHOLD = int(
        os.environ.get("HYDRIUM_STREAMING_THRESHOLD", "17"))

    def __init__(self, metadata: ImageMetadata,
                 backend: Optional[str] = None,
                 streaming: Optional[bool] = None,
                 spool_dir: Optional[str] = None, profile=None, *,
                 device="cuda", fused_front: Optional[bool] = None) -> None:
        metadata.validate()
        if profile is not None:
            if isinstance(profile, str):
                profile = get_profile(profile)
            backend = profile.backend
        backend = "torch" if backend is None else backend
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose 'torch' "
                             "(the device plane) or 'numpy' (the "
                             "conformance plane)")
        self.backend = backend
        on_device = backend == "torch"
        if on_device and not native.available():
            raise RuntimeError("the native serialization plane "
                               "(csrc/host/serializer.cc) failed to build; "
                               "the packed device path needs it")
        # the numpy plane keeps the device out entirely
        self.device = resolve_device(device) if on_device else None
        self.metadata = m = metadata
        self.spool_dir = spool_dir
        self.stats = EncodeStats()
        self._out = bytearray()
        self._emit_iter = None
        self._wrote_header = False
        self._finished = False
        self._icc_payload = None
        self._tb_units = []          # tiled-mode in-flight batch units
        self._tb_run = []            # pending cross-call stacked run
        self._tb_run_fmt = None      # the pending run's sample format
        self._tb_flush_pending = False
        self._sections: Optional[FrameSections] = None   # one-frame mode
        self._codec = self._new_codec() if on_device else None
        self.max_inflight = int(os.environ.get("HYDRIUM_INFLIGHT", "3"))
        self._pending = deque()      # one-frame (tag, future), oldest first
        self._front = (_front.FrontEnd.from_tables().to(self.device)
                       if on_device else None)
        self.fused_front = on_device and (default_fused() if fused_front
                                          is None else bool(fused_front))
        # single-group frames never stream, as in hydrium_tpu: they are
        # too small for streaming to matter
        multi_group = ((m.width + 255) // 256) * ((m.height + 255) // 256) > 1
        if streaming is not None or on_device:
            # the jax backend's rule: stream every multi-group one-frame
            # encode unless told otherwise
            self.streaming = (m.one_frame and multi_group
                              and (streaming is None or bool(streaming)))
        else:
            # the numpy plane, the byte-parity twin of the reference,
            # keeps the at-finalize scheme below the threshold
            self.streaming = (m.one_frame and multi_group
                              and native.available()
                              and m.lfg_per_frame
                              >= self.STREAMING_LFG_THRESHOLD)
        if m.one_frame:
            self._geo = one_frame_geometry(m.width, m.height)
            self._hf = None
            self._sent = set()
            # one ordered worker: joins each LF group's fetch, runs the
            # C++ walk (ctypes releases the GIL) and, in streaming mode,
            # the preset's ANS encode, so the HF stream is touched by
            # this thread only, in dispatch order, until finalize
            if on_device:
                self._drain_exec = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="hyd-drain")
        elif on_device:
            # made here, not at first use: units' fetch threads submit
            # renders (threads start at the first submit)
            self._tb_pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="hyd-tile")

    # -- public API -----------------------------------------------------

    def send_tile(self, pixels, tile_x: int = 0, tile_y: int = 0,
                  is_last: int = -1,
                  sample_fmt: SampleFormat = SampleFormat.UINT8) -> None:
        """Encode one tile.  `pixels` is [tile_h, tile_w, 3] in the tile's
        actual (possibly clipped) dimensions, or a (r, g, b) tuple of
        planar [tile_h, tile_w] arrays.  Strided numpy views are accepted
        either way."""
        if self._finished:
            raise RuntimeError("tile sent after the last tile")
        if isinstance(pixels, (tuple, list)):
            pixels = np.stack([np.asarray(p) for p in pixels], axis=-1)
        fmt = sample_fmt.value
        if self.metadata.one_frame:
            self._send_tile_one_frame(pixels, tile_x, tile_y, is_last, fmt)
        else:
            # deferred batch units must serialize BEFORE this tile
            self._tb_drain_all()
            self._send_tile_tiled(pixels, tile_x, tile_y, is_last, fmt)

    def take_output(self) -> bytes:
        """Drain every pending output byte (materializes the finalize
        stream; use iter_output for bounded-memory draining)."""
        if self._emit_iter is not None:
            for chunk in self._emit_iter:
                self._out.extend(chunk)
            self._emit_iter = None
        out = bytes(self._out)
        self._out.clear()
        self.stats.bytes_out += len(out)
        return out

    def iter_output(self, chunk_size: int = 1 << 22):
        """Yield pending output in bounded chunks.  In streaming mode
        the finalize emission reads spooled sections incrementally, so
        host memory stays bounded even when the encoded image does not
        fit in RAM."""
        if self._out:
            out = bytes(self._out)
            self._out.clear()
            self.stats.bytes_out += len(out)
            yield out
        if self._emit_iter is not None:
            buf = bytearray()
            for chunk in self._emit_iter:
                buf.extend(chunk)
                if len(buf) >= chunk_size:
                    self.stats.bytes_out += len(buf)
                    yield bytes(buf)
                    buf.clear()
            self._emit_iter = None
            if buf:
                self.stats.bytes_out += len(buf)
                yield bytes(buf)

    @property
    def finished(self) -> bool:
        return self._finished

    def close(self) -> None:
        """Drop spool-backed temp files immediately.  For ABANDONED
        encodes: a drained `iter_output`/`take_output` already cleans
        up, and weakref.finalize covers GC/interpreter exit.  Pending
        undelivered output becomes unreadable after this."""
        if self._sections is not None:
            self._sections.close()
        self._stop_workers()

    def _stop_workers(self) -> None:
        for name in ("_drain_exec", "_tb_pool"):
            pool = getattr(self, name, None)
            if pool is not None:
                pool.shutdown(wait=False)

    def _finish(self) -> None:
        """The last frame is out: persist the warm state, stop the
        worker threads."""
        self._finished = True
        if self.backend == "torch":
            _save_warm_state()
        self._stop_workers()

    def set_suggested_icc_profile(self, icc_data: Optional[bytes]) -> None:
        """libhydrium.c:242-305 (one-frame mode only, before first tile)."""
        if icc_data is None:
            self._icc_payload = None
            return
        if not self.metadata.one_frame:
            raise ValueError("one-frame mode required for ICC tagging")
        if self._wrote_header:
            raise RuntimeError("ICC must be set before the first tile")
        self._icc_payload = headers.mangle_icc_profile(icc_data)

    # -- common ---------------------------------------------------------

    def _new_codec(self) -> TokenCodec:
        return _shared_codec()

    def _dispatch(self, pixels, fmt: str, lfg, preset: int, hf,
                  lf_seg_vb: int = 0, tag=None) -> _TorchDispatch:
        """Stage `pixels` as one dispatch unit; the prep pool uploads
        them and enqueues its packed pipeline."""
        return _TorchDispatch(
            pixels, fmt, self.metadata.linear_light, lfg, preset, hf,
            self._codec, self._front, self.device, self.stats,
            fused=self.fused_front, lf_seg_vb=lf_seg_vb, tag=tag)

    def _image_header(self, bw: BitWriter) -> None:
        headers.write_image_header(
            bw, self.metadata.width, self.metadata.height,
            self.metadata.level10, self._icc_payload)
        self._wrote_header = True

    def _tile_is_last(self, tile_x: int, tile_y: int, tile_w: int,
                      tile_h: int, is_last: int) -> bool:
        if is_last >= 0:
            return bool(is_last)
        return ((tile_x + 1) * tile_w >= self.metadata.width
                and (tile_y + 1) * tile_h >= self.metadata.height)

    # -- tiled mode ------------------------------------------------------
    #
    # Units in flight are dicts: "chunk" (a stack of full-size tiles,
    # dispatched when it is made; a thread of its own fetches and parses
    # it and submits its tiles' renders to the 4-worker pool) and "edge"
    # (one clipped tile, dispatched and its fetch started when it is
    # made, walked when it drains).  Frames leave in send order; the
    # calling thread only joins (stage "fetch_wait").

    def _tile_geometry(self, tile_x: int, tile_y: int) -> LFGroupGeometry:
        m = self.metadata
        tw, th = m.tile_width, m.tile_height
        if tile_x >= (m.width + tw - 1) // tw or \
                tile_y >= (m.height + th - 1) // th:
            raise ValueError("tile out of bounds")
        return LFGroupGeometry(
            x=tile_x, y=tile_y,
            width=min(tw, m.width - tile_x * tw),
            height=min(th, m.height - tile_y * th),
            tile_count_x=1 << m.tile_size_shift_x,
            tile_count_y=1 << m.tile_size_shift_y)

    def _render_tiled_frame(self, lfg: LFGroupGeometry, last: bool,
                            lf_q, lf_res, hf,
                            include_header: bool) -> bytes:
        """Serialize one tile-frame (header, LF sections, HF sections,
        TOC) from an already-fed HF stream; returns the frame bytes.
        Pure function of its arguments -- safe to run on a worker
        thread (the per-frame ANS encode releases the GIL in C++).  Its
        spans carry the tile's (y, x); counts one tile_frames."""
        m = self.metadata
        tag = (lfg.y, lfg.x)
        self.stats.count("tile_frames")
        geo = FrameGeometry(
            image_width=m.width, image_height=m.height, one_frame=False,
            lfg_count_x=1, lf_groups=[lfg], lfg_arrival=[0])
        main = new_bitwriter()
        if include_header:
            # written WITHOUT touching self._wrote_header: this runs on
            # render pool threads; the claim sites own the flag
            headers.write_image_header(main, m.width, m.height, m.level10,
                                       self._icc_payload)
        write_frame_header(main, geo, last)
        frame = FrameSections(geo.toc_size > 1)
        with self.stats.stage("lf_sections", tag):
            frame.write(write_lf_global)
            frame.write(write_lf_group, lf_q, lf_res)
        with self.stats.stage("ans_encode", tag):
            encoded = hf.encode_group_sections()
        self.stats.count("ans_symbols", encoded)
        frame.write(hf.write_hf_global, geo.num_frame_groups)
        for gbw in hf.group_sections:
            frame.add(gbw.export_raw())
        frame.write_toc(main)
        return b"".join([main.finalize(), *frame.chunks()])

    def _emit_tiled_frame(self, lfg: LFGroupGeometry, last: bool,
                          lf_q, lf_res, hf,
                          include_header: Optional[bool] = None) -> None:
        if include_header is None:
            include_header = not self._wrote_header
        if include_header:
            self._wrote_header = True
        with self.stats.stage("render", (lfg.y, lfg.x)):
            data = self._render_tiled_frame(lfg, last, lf_q, lf_res, hf,
                                            include_header)
        self._out.extend(data)
        if last:
            self._finish()

    def _send_tile_tiled(self, pixels, tile_x, tile_y, is_last, fmt) -> None:
        m = self.metadata
        lfg = self._tile_geometry(tile_x, tile_y)
        last = self._tile_is_last(tile_x, tile_y, m.tile_width,
                                  m.tile_height, is_last)
        hf = HFStream(1)
        self.stats.pixels += lfg.height * lfg.width
        with self.stats.stage("pipeline+transfer", (lfg.y, lfg.x)):
            if self.backend == "numpy":
                lf_q, lf_res = _lfg_numpy(pixels, fmt, m.linear_light, lfg,
                                          0, hf)
            else:
                lf_q, lf_res = self._dispatch(pixels, fmt, lfg, 0,
                                              hf).drain()
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
        format changes.  Clipped edge tiles run one at a time.  Every
        unit's payload comes back on a thread of its own.  Frames are
        emitted strictly in send order, all but the last two units by
        the end of each call (HYDRIUM_INFLIGHT=1 keeps one; 0 drains
        each unit as soon as it is dispatched).  The numpy plane, and
        one-frame mode, send the tiles one at a time."""
        if self._finished:
            raise RuntimeError("tile sent after the last tile")
        m = self.metadata
        if m.one_frame or self.backend != "torch":
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
                    self._tb_add(self._tb_chunk(run, fmt, k_stack))
                    run = []
                continue
            if run:
                self._tb_add(self._tb_chunk(run, fmt, k_stack))
                run = []
            hf = HFStream(1)
            with self.stats.stage("dispatch", (ty, tx)):
                handle = self._dispatch(pixels, fmt, lfg, 0, hf)
            handle.start_fetch()
            include_header = not self._wrote_header
            self._wrote_header = True
            self._tb_add({"kind": "edge", "handle": handle, "hf": hf,
                          "lfg": lfg, "tx": tx, "ty": ty,
                          "include_header": include_header})
        contains_last = any(self._tile_is_last(tx, ty, tw, th, -1)
                            for _p, tx, ty in entries)
        if run:
            if contains_last or self._tb_flush_pending:
                self._tb_add(self._tb_chunk(run, fmt, k_stack))
            else:
                self._tb_run, self._tb_run_fmt = run, fmt
        keep = 0 if contains_last else min(2, self.max_inflight)
        while len(self._tb_units) > keep:
            self._tb_drain_unit(self._tb_units.pop(0))

    def _tb_add(self, unit) -> None:
        """Queue a dispatched unit; with a window of 0 drain it (and any
        before it) at once, so that nothing overlaps."""
        self._tb_units.append(unit)
        while self.max_inflight == 0 and self._tb_units:
            self._tb_drain_unit(self._tb_units.pop(0))

    def _tb_chunk(self, part, fmt: str, k_stack: int) -> dict:
        """Stack the full-size tiles of `part` ((pixels, tx, ty, lfg)
        each) into one k_stack-tile buffer and dispatch it; the unit's
        own thread fetches it, parses it and submits its tiles' renders.
        On a payload that does not pack (ok = 0), the unit keeps no
        result and re-encodes tile by tile when it drains, under its own
        sample format."""
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
        # the unit's spans carry its first tile's (y, x)
        tag = (part[0][2], part[0][1])
        with self.stats.stage("dispatch", tag):
            # HFStream(1) sets the class count (9); the walk is per tile
            handle = self._dispatch(px, fmt, geo, 0, HFStream(1),
                                    lf_seg_vb=th >> 3, tag=tag)
        unit = {"kind": "chunk", "px": px, "fmt": fmt, "tag": tag,
                "metas": [(tx, ty, lfg) for _p, tx, ty, lfg in part],
                "include_header": include_header, "result": None,
                "futs": None}
        unit["fetch"] = _spawn(self._tb_fetch_chunk, unit, handle, geo)
        return unit

    def _tb_fetch_chunk(self, unit, handle: _TorchDispatch, geo) -> None:
        """On the unit's own thread: fetch, parse, submit the renders."""
        with self.stats.stage("pipeline+transfer", handle.tag):
            aux, words = handle.join()
            parsed = None
            if words is not None:
                with self.stats.stage("parse", handle.tag):
                    parsed = _host._parse_packed(aux, words, geo.height,
                                                 geo.width, geo,
                                                 handle.lf_lut)
        if parsed is None:
            self.stats.count("lfg_fallback")
            return
        self.stats.count("lfg_packed")
        unit["result"] = (parsed, handle.tok_lut)
        self._tb_submit_renders(unit)

    def _tb_drain_unit(self, unit) -> None:
        """Emit one unit's frames (send order), joining its fetch thread
        and its renders; what they raised is raised here.  A chunk
        without a result re-encodes its tiles one by one under the
        sample format it was sent with, unit["fmt"]."""
        m = self.metadata
        tw, th = m.tile_width, m.tile_height
        if self._finished:
            raise RuntimeError("tile sent after the last tile")
        if unit["kind"] == "edge":
            last = self._tile_is_last(unit["tx"], unit["ty"], tw, th, -1)
            handle = unit["handle"]
            with self.stats.stage("fetch_wait", handle.tag):
                handle.join()
            with self.stats.stage("pipeline+transfer", handle.tag):
                lf_q, lf_res = handle.drain()
            self._emit_tiled_frame(unit["lfg"], last, lf_q, lf_res,
                                   unit["hf"],
                                   include_header=unit["include_header"])
            return
        with self.stats.stage("fetch_wait", unit["tag"]):
            unit["fetch"].result()
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
        for f, last, tag in unit["futs"]:
            if self._finished:
                raise RuntimeError("tile sent after the last tile")
            with self.stats.stage("fetch_wait", tag):
                frame = f.result()
            self._out.extend(frame)
            if last:
                self._finish()

    def _tb_submit_renders(self, unit) -> None:
        """Submit a fetched chunk unit's per-tile walk + ANS + frame
        serialization to the 4-worker pool (called on the unit's fetch
        thread as soon as its payload parses; the walker and ANS encoder
        release the GIL in C++).  Stage render_queue times each tile's
        wait for a worker, from its submit to the start of its render.
        Results are collected strictly in send order by _tb_drain_unit."""
        m = self.metadata
        tw, th = m.tile_width, m.tile_height
        gpt = (th >> 8) * (tw >> 8)
        parsed, lut = unit["result"]

        def render(queued, j, lfg, last, include_header):
            queued.close()
            g0, g1 = j * gpt, (j + 1) * gpt
            lf0 = j * (th >> 3)
            hf = HFStream(1)
            tag = (lfg.y, lfg.x)
            with self.stats.stage("render", tag):
                with self.stats.stage("walk", tag):
                    # the walker's class modulus is the LUT's row count,
                    # which must equal the dispatch's tok_classes
                    hf.add_lfg_packed(parsed["tok_words"],
                                      parsed["res_words"], lut, 0,
                                      (th >> 8, tw >> 8), (th >> 3, tw >> 3),
                                      parsed["tok_off"][g0:g1],
                                      parsed["res_off"][g0:g1],
                                      parsed["gs"][g0:g1])
                self.stats.count("walk_symbols",
                                 int(parsed["gs"][g0:g1].sum()))
                return self._render_tiled_frame(
                    lfg, last, None, parsed["lf_res"][lf0:lf0 + (th >> 3)],
                    hf, include_header)

        pool = self._tb_pool
        futs = []
        for j, (tx, ty, lfg) in enumerate(unit["metas"]):
            last = self._tile_is_last(tx, ty, tw, th, -1)
            queued = self.stats.queued("render_queue", (ty, tx))
            futs.append((pool.submit(render, queued, j, lfg, last,
                                     unit["include_header"] and j == 0),
                         last, (ty, tx)))
        unit["futs"] = futs

    def _tb_drain_all(self) -> None:
        if self._tb_run:
            # dispatch the pending cross-call run first -- nothing may
            # emit ahead of tiles already accepted (send order); the run
            # flushes under ITS OWN sample format, not the new tile's
            self._tb_flush_pending = True
            try:
                self.send_tile_batch(
                    [], sample_fmt=SampleFormat(self._tb_run_fmt))
            finally:
                self._tb_flush_pending = False
        while self._tb_units:
            self._tb_drain_unit(self._tb_units.pop(0))

    # -- one-frame mode -------------------------------------------------

    def _send_tile_one_frame(self, pixels, tile_x, tile_y, is_last,
                             fmt) -> None:
        m = self.metadata
        if tile_x >= m.lfg_count_x or tile_y >= m.lfg_count_y:
            raise ValueError("tile out of bounds")
        lfid = tile_y * m.lfg_count_x + tile_x
        if lfid in self._sent:
            raise ValueError("tile already sent")
        last = self._tile_is_last(tile_x, tile_y, 2048, 2048, is_last)

        geo = self._geo
        if self._sections is None:
            # a streaming encode's sections, LF and HF, go to one store,
            # spooled when spool_dir is given
            self._sections = FrameSections(
                geo.toc_size > 1, self.spool_dir if self.streaming else None)
            self._hf = (StreamingHFStream(geo.num_presets,
                                          geo.preset_lfg_counts,
                                          self._sections)
                        if self.streaming else HFStream(geo.num_presets))
            self._sections.write(write_lf_global)

        lfg = geo.lf_groups[lfid]
        self.stats.pixels += lfg.height * lfg.width
        self._process_lfg(pixels, lfid, fmt)

        if last:
            for missing, lfg in enumerate(geo.lf_groups):
                if missing not in self._sent:
                    zeros = np.zeros((lfg.height, lfg.width, 3),
                                     dtype=np.uint8 if fmt == "uint8"
                                     else np.uint16 if fmt == "uint16"
                                     else np.float32)
                    self._process_lfg(zeros, missing, fmt)
            while self._pending:
                self._drain_one()
            self._finalize_one_frame()

    def _process_lfg(self, pixels, lfid: int, fmt: str) -> None:
        """Dispatch one LF group, start its fetch, queue its walk on the
        drain worker, and drain the oldest groups beyond the window.  The
        numpy plane encodes it here, in full, on the calling thread."""
        lfg = self._geo.lf_groups[lfid]
        self._sent.add(lfid)
        self._geo.lfg_arrival.append(lfid)
        preset = lfid // self._geo.lfg_per_preset
        tag = (lfg.y, lfg.x)
        if self.backend == "numpy":
            with self.stats.stage("pipeline+transfer", tag):
                lf_q, lf_res = _lfg_numpy(pixels, fmt,
                                          self.metadata.linear_light, lfg,
                                          preset, self._hf)
            self._write_lf(lf_q, lf_res, tag)
            if self.streaming:
                with self.stats.stage("ans_encode", tag):
                    encoded = self._hf.finish_lfg(preset)
                self.stats.count("ans_symbols", encoded)
            return
        with self.stats.stage("dispatch", tag):
            handle = self._dispatch(pixels, fmt, lfg, preset, self._hf)
        handle.start_fetch()
        self._pending.append((tag, self._drain_exec.submit(self._drain_work,
                                                           handle)))
        while len(self._pending) > self.max_inflight:
            self._drain_one()

    def _drain_work(self, handle: _TorchDispatch):
        """On the drain worker, in dispatch order: join the fetch, walk
        the payload into the HF stream (or run the unpacked fallback),
        and in streaming mode finish the preset's ANS sections."""
        with self.stats.stage("pipeline+transfer", handle.tag):
            lf_q, lf_res = handle.drain()
        if self.streaming:
            with self.stats.stage("ans_encode", handle.tag):
                encoded = self._hf.finish_lfg(handle.preset)
            self.stats.count("ans_symbols", encoded)
        return lf_q, lf_res

    def _drain_one(self) -> None:
        """Wait for the oldest LF group in flight (what its threads
        raised is raised here) and write its LF section."""
        tag, fut = self._pending.popleft()
        with self.stats.stage("fetch_wait", tag):
            lf_q, lf_res = fut.result()
        self._write_lf(lf_q, lf_res, tag)

    def _write_lf(self, lf_q, lf_res, tag) -> None:
        with self.stats.stage("lf_sections", tag):
            self._sections.write(write_lf_group, lf_q, lf_res)

    def _finalize_one_frame(self) -> None:
        hf = self._hf
        geo = self._geo
        with self.stats.stage("ans_encode"):
            encoded = hf.encode_group_sections()
        self.stats.count("ans_symbols", encoded)
        frame = self._sections
        frame.write(hf.write_hf_global, geo.num_frame_groups,
                    key=HF_GLOBAL_KEY)
        if not self.streaming:
            for gbw in hf.group_sections:
                frame.add(gbw.export_raw(), HF_GROUPS_KEY)
        main = new_bitwriter()
        if not self._wrote_header:
            self._image_header(main)
        write_frame_header(main, geo, True)
        frame.write_toc(main)
        # drained lazily: iter_output reads spooled sections as it goes,
        # and the store removes its spool when the last one is out
        self._emit_iter = itertools.chain([main.finalize()], frame.chunks())
        self._finish()


# BufferedEncoder.send_tile / pump status values (reference HYD_OK /
# HYD_NEED_MORE_OUTPUT, libhydrium.h)
OK = "ok"
NEED_MORE_OUTPUT = "need-more-output"


class BufferedEncoder:
    """Push-model (caller-owned output buffer) adapter over `Encoder`.

    Reference parity for the buffer-swap output contract:
    hyd_provide_output_buffer / HYD_NEED_MORE_OUTPUT /
    hyd_release_output_buffer (libhydrium.c:114-166, bitwriter.c:42-73).
    The core Encoder is pull-model (`iter_output`); this adapter restores the reference surface: output lands only in
    buffers the CALLER owns, `send_tile` suspends with NEED_MORE_OUTPUT
    when one fills mid-drain, and encoding resumes after
    release_output_buffer + provide_output_buffer + pump -- the
    reference's swap-and-recall loop.  Host memory stays bounded by the
    spool exactly as in the pull model.

        buf = bytearray(1 << 20)
        be = BufferedEncoder(Encoder(meta, device=...))
        be.provide_output_buffer(buf)
        st = be.send_tile(px, 0, 0)
        while st == NEED_MORE_OUTPUT:
            n = be.release_output_buffer()
            sink.write(buf[:n])
            be.provide_output_buffer(buf)
            st = be.pump()
    """

    def __init__(self, encoder: Encoder) -> None:
        self.encoder = encoder
        self._buf: Optional[memoryview] = None
        self._pos = 0
        self._chunks = deque()      # (bytes, consumed-offset) backlog
        self._emit = None           # live iter_output generator

    def provide_output_buffer(self, buf) -> None:
        """Hand the encoder a writable caller-owned byte buffer
        (bytearray / writable memoryview; libhydrium.c:114-136)."""
        if self._buf is not None:
            raise RuntimeError("release the current output buffer first")
        view = memoryview(buf).cast("B")
        if view.readonly:
            raise ValueError("output buffer must be writable")
        if len(view) < 64:
            # reference parity: hyd_provide_output_buffer rejects
            # buffers under 64 bytes (libhydrium.c); tiny buffers would
            # also degenerate _drain into a byte-at-a-time loop
            raise ValueError("output buffer must be at least 64 bytes")
        self._buf = view
        self._pos = 0

    def release_output_buffer(self) -> int:
        """Reclaim the current buffer; returns the bytes written into it
        (libhydrium.c:138-151).  The encoder holds no reference to the
        buffer afterwards."""
        if self._buf is None:
            raise RuntimeError("no output buffer provided")
        n = self._pos
        self._buf.release()
        self._buf = None
        self._pos = 0
        return n

    def send_tile(self, pixels, tile_x: int = 0, tile_y: int = 0,
                  is_last: int = -1,
                  sample_fmt: SampleFormat = SampleFormat.UINT8) -> str:
        """Encode one tile, draining its output into the provided
        buffer.  Returns NEED_MORE_OUTPUT when the buffer filled first:
        release/swap buffers and `pump()` until OK before sending the
        next tile.  If called while output is still pending it resumes
        the drain without re-encoding (the reference tolerates the same
        re-call after a swap)."""
        if self._drain() == NEED_MORE_OUTPUT:
            return NEED_MORE_OUTPUT
        self.encoder.send_tile(pixels, tile_x, tile_y, is_last, sample_fmt)
        return self._drain()

    def pump(self) -> str:
        """Continue copying pending output after a buffer swap; OK means
        everything produced so far has been delivered."""
        return self._drain()

    @property
    def finished(self) -> bool:
        """True once the last tile was encoded AND fully delivered."""
        return (self.encoder.finished and not self._chunks
                and self._emit is None and not self.encoder._out
                and self.encoder._emit_iter is None)

    def _drain(self) -> str:
        if self._buf is None:
            raise RuntimeError("no output buffer provided")
        while True:
            if not self._chunks:
                nxt = self._next_chunk()
                if nxt is None:
                    return OK
                self._chunks.append((nxt, 0))
            chunk, off = self._chunks[0]
            room = len(self._buf) - self._pos
            take = min(room, len(chunk) - off)
            self._buf[self._pos:self._pos + take] = chunk[off:off + take]
            self._pos += take
            if off + take < len(chunk):
                self._chunks[0] = (chunk, off + take)
                return NEED_MORE_OUTPUT
            self._chunks.popleft()

    def _next_chunk(self) -> Optional[bytes]:
        # A paused iter_output generator only exists while this adapter
        # reports NEED_MORE_OUTPUT (send_tile refuses to encode then),
        # so the encoder never adds output behind a live generator's
        # back; when one ends, the next call starts a fresh one.
        # The pull granularity follows the CALLER's buffer size, so the
        # adapter's internal backlog stays ~one buffer's worth -- the
        # memory-bound the reference achieves by suspending mid-section
        # (libhydrium.c:114-166); a tiny 64-byte buffer holds the
        # backlog near the spool read unit instead of a 4 MB chunk.
        if self._emit is None:
            cs = max(64, len(self._buf)) if self._buf is not None \
                else 1 << 16
            self._emit = self.encoder.iter_output(chunk_size=cs)
        for c in self._emit:
            if c:
                return c
        self._emit = None
        return None


def encode_image(image: np.ndarray, tile_size_shift: int = -1,
                 linear_light: bool = False,
                 sample_fmt: Optional[SampleFormat] = None,
                 backend: Optional[str] = None, *, device="cuda",
                 stats: Optional[EncodeStats] = None,
                 fused_front: Optional[bool] = None, profile=None) -> bytes:
    """One-shot encode of an [H, W, 3] array to .jxl bytes on `device`:
    one frame (tile_size_shift -1) or tiles of 256 << tile_size_shift,
    sent through send_tile_batch 16 at a time.  backend / profile choose
    the math plane as Encoder's do (profile="conformance" is the numpy
    plane, which ignores `device`).  `stats`, when given, receives the
    encode's stage times and counters (lfg_packed, lfg_fallback,
    wide_retries, codec_bootstraps, and the bytes that crossed the link:
    h2d_raw_bytes uploaded, fetched_words copied back).  The positional
    parameters are hydrium_tpu.encode_image's, in its order; the rest
    are keyword-only."""
    if sample_fmt is None:
        sample_fmt = {np.dtype(np.uint8): SampleFormat.UINT8,
                      np.dtype(np.uint16): SampleFormat.UINT16}.get(
                          image.dtype, SampleFormat.FLOAT32)
    h, w = image.shape[:2]
    meta = ImageMetadata(width=w, height=h, linear_light=linear_light,
                         tile_size_shift_x=tile_size_shift,
                         tile_size_shift_y=tile_size_shift)
    enc = Encoder(meta, device=device, fused_front=fused_front,
                  backend=backend, profile=profile)
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
