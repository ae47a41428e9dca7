"""Compile once, replay per dispatch: the port's counterpart of the
jitted packed pipeline.  On a CUDA device a dispatch whose static key
has been dispatched before replays a torch.cuda.CUDAGraph of
ops/packed.py::encode_lfg_packed, captured once per key.

The JAX package jits pipeline.encode_lfg_packed with static argnames
(hydrium_tpu/ops/pipeline.py:1147): shapes are static buffers with
dynamic valid dims, so every LF group of an image reuses one compiled
executable.  Run eagerly, the same function is ~100 launches enqueued
from Python a dispatch, and on the card that enqueue sets the fused
device plane's pace; a graph enqueues them in one call.  The eager
function stays the graph's body and the CPU's path.

The key (packed_key) is everything a graph bakes in: the device, the
upload shape (ubuf_h, ubuf_w) and pixel dtype, the true extent (height,
width), the buffer (buf_h, buf_w), linear_light, sample_kind,
tok_classes, lf_seg_vb, wide_residues, fused, and the digest of the
front's tables (FrontEnd.digest: a graph reads the buffers of the front
it was captured with, so a front with other tables gets a graph of its
own).  JAX passes height and width as traced scalars; here they reach
csrc/frontend.cu as kernel arguments and the front's masks as Python
ints, so they are part of the key.  That costs little: uploads are
bucketed to 32 rows and buffers to 256, so a one-frame 4K encode has
four LF-group shapes either way, every stacked tiled chunk shares one
key, and a 16384^2 frame runs all 64 of its LF groups on one.

A key's first dispatch runs the body eagerly: a key dispatched once (as
each LF group of a one-frame 4K encode is, in a fresh process) costs
nothing beyond the eager run, and that run has loaded the kernels and
the body's library state before any capture.  Its second dispatch
captures the graph and replays it; every later one replays.

Between replays of one key only the static inputs change.  Before each
replay they are copied in on the caller's current stream: the pixels
[ubuf_h, ubuf_w, 3] (device to device: the dispatch's own upload stays,
since the unpacked fallback reads it after later replays), the presets
[G] int32, and the transport code tables tok_len / tok_code int32
[10*64] (from pinned host memory or the device).

A replay writes the graph's static `combined`, which is cloned into a
fresh tensor on the same stream before the lock is let go.  Several
payloads of one key can be in flight at once (the HYDRIUM_INFLIGHT
window, two prep workers, the bootstrap and wide re-dispatches from
fetch threads), and a later replay must not overwrite one whose fetch
is still pending.

Each graph owns a private memory pool with every intermediate of one
dispatch.  Graphs share no pool: that is safe only when they replay in
the order they were captured, and these do not.  The cache bounds the
device memory its graphs' captures reserved, BUDGET bytes per device
(PERF.md §5 derives it from the measured pools and peaks); past it the
least recently used graphs leave.  Eviction drops the graph without a
device synchronize: CUDA frees an executable graph still in flight when
it completes, the static inputs are released on the stream their
replays ran on (record_stream where that is not the stream they were
made on), and the caching allocator hands a released private pool back
to the device only through its own synchronizing release (empty_cache,
or a failed allocation's retry).  graph_stats() reports eager first
dispatches, captures, replays, evictions and live graphs per device,
with each live key's capture seconds and reserved memory.

The kernels' wrappers count a launch when they run: on an eager
dispatch and during a capture once (the capture's own replay follows at
once and adds nothing), during a later replay never, so the cache adds
the launches its capture recorded on each later replay.  chip_smoke.py
holds these counts to the kernels a torch.profiler trace of the main
path sees launched.

A capture runs on a side stream of the cache's, under
capture_error_mode="thread_local", so that the fetch threads'
device-to-host copies and event waits may go on meanwhile, and without
torch.cuda.graph's device synchronize and gc pass.  A capture or replay
error raises to the caller; there is no eager fallback on the card.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Dict

import torch

from . import packed as _packed
from .bitpack import pack_chunks
from .frontend import frontend_groups, frontend_tokens
from .transport import transport_prep

# device memory the live graphs of one device may have reserved
BUDGET = 8 << 30
# keys dispatched once and remembered per device, awaiting a second
SEEN = 256
# the kernels' wrappers, whose .launches count launches
_WRAPPERS = (transport_prep, pack_chunks, frontend_tokens, frontend_groups)


def _counts() -> tuple:
    return tuple(f.launches for f in _WRAPPERS)


def _add_counts(delta, sign: int = 1) -> None:
    for f, d in zip(_WRAPPERS, delta):
        f.launches += sign * d


def packed_key(front, pixels: torch.Tensor, height: int, width: int, *,
               buf_h: int, buf_w: int, linear_light: bool,
               sample_kind: str, lf_seg_vb: int = 0, tok_classes: int = 9,
               wide_residues: bool = False, fused: bool = False) -> tuple:
    """The static key of one dispatch (module docstring)."""
    return (pixels.device, tuple(pixels.shape[:2]), pixels.dtype,
            (int(height), int(width)), (int(buf_h), int(buf_w)),
            bool(linear_light), sample_kind, int(tok_classes),
            int(lf_seg_vb), bool(wide_residues), bool(fused), front.digest)


def eager(front, pixels, height, width, presets, tok_len, tok_code,
          **kw) -> torch.Tensor:
    """ops/packed.py::encode_lfg_packed run eagerly on pixels' device,
    the code tables copied there first (they may be in pinned host
    memory)."""
    dev = pixels.device
    return _packed.encode_lfg_packed(
        front, pixels, height, width, presets,
        tok_len.to(dev, non_blocking=True),
        tok_code.to(dev, non_blocking=True), **kw)


class PackedGraph:
    """One captured dispatch: static inputs, the CUDA graph, its static
    output.  `launches` holds the kernels' launches of one replay (in
    _WRAPPERS' order), `capture_s` the seconds of the capture,
    `reserved_bytes` the device memory the capture reserved."""

    def __init__(self, front, pixels, height, width, presets, tok_len,
                 tok_code, *, stream: torch.cuda.Stream, **kw) -> None:
        dev = pixels.device
        self.front = front
        self._stream = torch.cuda.current_stream(dev)
        self.px = torch.empty(pixels.shape, dtype=pixels.dtype, device=dev)
        self.presets = torch.empty(presets.shape, dtype=torch.int32,
                                   device=dev)
        self.tok_len = torch.empty(tok_len.shape, dtype=torch.int32,
                                   device=dev)
        self.tok_code = torch.empty(tok_code.shape, dtype=torch.int32,
                                    device=dev)
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph()
        before = _counts()
        with torch.cuda.stream(stream):
            # this thread's cuBLAS handle and the side stream's
            # workspace, made before the capture (the body's einsums)
            torch.cuda.current_blas_handle()
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = _packed.encode_lfg_packed(
                    front, self.px, height, width, self.presets,
                    self.tok_len, self.tok_code, **kw)
            finally:
                self.graph.capture_end()
        self.launches = tuple(b - a for a, b in zip(before, _counts()))
        self.reserved_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0

    def replay(self, pixels, presets, tok_len, tok_code) -> torch.Tensor:
        """Copy the inputs in, replay, and return a clone of the output,
        all on the current stream."""
        cur = torch.cuda.current_stream(self.px.device)
        ins = (self.px, self.presets, self.tok_len, self.tok_code)
        for t, src in zip(ins, (pixels, presets, tok_len, tok_code)):
            t.copy_(src, non_blocking=True)
            if cur != self._stream:
                t.record_stream(cur)
        self.graph.replay()
        return self.out.clone()

    def close(self) -> None:
        """Drop the graph and its pool (module docstring: no device
        synchronize is needed)."""
        self.graph.reset()
        self.graph = self.out = None


class GraphCache:
    """Graphs by static key, their captures' reserved memory at most
    `budget` bytes per device, least recently used evicted first.  A
    key's first dispatch runs `eager`, its second `capture` (PackedGraph;
    tests inject stubs, so that the cache runs on the CPU).  One
    dispatch runs at a time: the static inputs and output are shared by
    every replay of a key."""

    def __init__(self, budget: int = BUDGET, capture: Callable = PackedGraph,
                 eager: Callable = eager) -> None:
        self.budget = budget
        self._capture = capture
        self._eager = eager
        self._lock = threading.Lock()
        self._graphs: Dict[torch.device, OrderedDict] = {}
        self._seen: Dict[torch.device, OrderedDict] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._stats: Dict[torch.device, dict] = {}
        self._replays: Dict[tuple, int] = {}

    def run(self, front, pixels, height, width, presets, tok_len, tok_code,
            **kw) -> torch.Tensor:
        """The payload of one dispatch (the arguments of
        ops/packed.py::encode_lfg_packed): eagerly at the key's first
        dispatch, else from the key's graph, captured at its second."""
        key = packed_key(front, pixels, height, width, **kw)
        dev = pixels.device
        with self._lock:
            lru = self._graphs.setdefault(dev, OrderedDict())
            seen = self._seen.setdefault(dev, OrderedDict())
            st = self._stats.setdefault(dev, {
                "eager": 0, "captures": 0, "replays": 0, "evictions": 0})
            graph = lru.get(key)
            if graph is not None:
                lru.move_to_end(key)
                out = graph.replay(pixels, presets, tok_len, tok_code)
                _add_counts(graph.launches)
            elif key not in seen:
                seen[key] = None
                if len(seen) > SEEN:
                    seen.popitem(last=False)
                st["eager"] += 1
                return self._eager(front, pixels, height, width, presets,
                                   tok_len, tok_code, **kw)
            else:
                del seen[key]
                before = _counts()
                try:
                    graph = self._capture(
                        front, pixels, height, width, presets, tok_len,
                        tok_code, stream=self._side(dev), **kw)
                except BaseException:
                    # a failed capture launched nothing
                    _add_counts([b - a for a, b in zip(before, _counts())],
                                -1)
                    raise
                st["captures"] += 1
                lru[key] = graph
                self._replays[key] = 0
                out = graph.replay(pixels, presets, tok_len, tok_code)
                self._evict(lru, st)
            self._replays[key] += 1
            st["replays"] += 1
        return out

    def _side(self, dev: torch.device):
        """The device's capture stream (None on the CPU, for stubs)."""
        if dev.type != "cuda":
            return None
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]

    def _evict(self, lru: OrderedDict, st: dict) -> None:
        """Drop the least recently used graphs until the rest fit the
        budget; the newest stays."""
        while len(lru) > 1 and sum(
                g.reserved_bytes for g in lru.values()) > self.budget:
            old_key, old = lru.popitem(last=False)
            del self._replays[old_key]
            old.close()
            st["evictions"] += 1

    def stats(self) -> dict:
        """{device: {eager, captures, replays, evictions, live,
        reserved_mib, graphs: [{key, capture_s, reserved_mib, replays},
        ...]}}, the graphs least recently used first; empty where no
        dispatch ran."""
        with self._lock:
            return {str(dev): dict(
                st, live=len(self._graphs[dev]),
                reserved_mib=sum(g.reserved_bytes for g in
                                 self._graphs[dev].values()) / 2 ** 20,
                graphs=[{"key": key_text(k), "capture_s": g.capture_s,
                         "reserved_mib": g.reserved_bytes / 2 ** 20,
                         "replays": self._replays[k]}
                        for k, g in self._graphs[dev].items()])
                for dev, st in self._stats.items()}

    def clear(self) -> None:
        """Drop every graph and every key seen once (the counts stay)."""
        with self._lock:
            for lru in self._graphs.values():
                while lru:
                    key, graph = lru.popitem(last=False)
                    del self._replays[key]
                    graph.close()
            for seen in self._seen.values():
                seen.clear()


def key_text(key: tuple) -> str:
    """A packed_key as graph_stats() names it."""
    (_dev, (uh, uw), dtype, (h, w), (bh, bw), linear, kind, per, seg, wide,
     fused, front) = key
    return (f"{h}x{w} in {bh}x{bw} (upload {uh}x{uw} "
            f"{str(dtype).replace('torch.', '')}) {kind}"
            f"{' linear' if linear else ''} classes {per}"
            f"{f' seg {seg}' if seg else ''}{' wide' if wide else ''}"
            f"{' fused' if fused else ''} front {front}")


_CACHE = GraphCache()


def encode_lfg_packed(front, pixels: torch.Tensor, height: int, width: int,
                      presets: torch.Tensor, tok_len: torch.Tensor,
                      tok_code: torch.Tensor, **kw) -> torch.Tensor:
    """ops/packed.py::encode_lfg_packed through the process's graph
    cache: the same arguments (tok_len / tok_code on the device or in
    pinned host memory) and the same payload, in a tensor of its own.
    CUDA tensors only: the CPU runs the eager function."""
    if pixels.device.type != "cuda":
        raise ValueError(
            f"graphs.encode_lfg_packed: CUDA graphs need pixels on a CUDA "
            f"device, not {pixels.device}; on the CPU call "
            "ops/packed.py::encode_lfg_packed")
    with torch.cuda.device(pixels.device):
        return _CACHE.run(front, pixels, height, width, presets, tok_len,
                          tok_code, **kw)


def graph_stats() -> dict:
    """The process's graphs per device (GraphCache.stats)."""
    return _CACHE.stats()


def clear_graphs() -> None:
    """Drop the process's graphs and the keys it has seen once, so that
    the next dispatches start as a fresh process's do."""
    _CACHE.clear()
