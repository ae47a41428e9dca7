"""BASELINE configs 4 and 5 on the port: the twin of the JAX package's
scripts/scale_artifacts.py and scripts/config5_virtual.py.

    python -m hydrium_tpu_torch.scale [--only config4|config5_cli|config5_multi]
        [--size N] [--height H] [--quick] [--device cuda|cpu] [--out PATH]

Configs (BASELINE.md, configs 4 and 5):
- config4: a 7680x4320 u16 one-frame encode, Encoder.send_tile with
  sample_fmt uint16 per 2048^2 LF group, take_output after each; a cold
  pass, then a warm pass that is timed.  Decode PSNR through libjxl
  where it loads (null, with the reason, where it does not).
- config5_cli: SyntheticImage written as a PNG one strip of rows at a
  time, then hydrium_tpu_torch.cli.main([png, out, "--one-frame",
  "--stats"]) in a child process, so that its peak RSS is this encode's
  alone.  Reports the level-10 container flag (from the file's first
  bytes), the peak RSS (the child's resident size, sampled every 5 ms
  while it encodes) and the RSS growth: the peak less the child's
  resident size after its device is up and one small encode has run.
  The growth is what shows streaming.
- config5_multi: `processes` children (one gloo group on localhost)
  run parallel/multihost.encode_image_multihost on SyntheticImage,
  each synthesizing only its own LF groups; all share one device.
  Process 0's file is held to a single-process streaming Encoder's
  (or to config5_cli's file, which has the same pixels, when both run).
  Per process: wall, peak RSS, RSS growth, bytes.

On a card every config also reports each process's device memory: the
peak that its caching allocator reserved (config4: over both passes;
a child: over its life) and the CUDA graphs it kept (ops/graphs.py).

--size N / --height H set the frame of every config that runs (config
4: 7680x4320, config 5: 16384x16384 by default; --quick: 1920x1080 and
4096x4096); the height defaults to the width for config 5.  --only may
be given more than once.  One JSON line is printed per config, with the
card's name and power limit; a config that fails prints its error, and
the exit code is then 1.  Every run is reported as it came: nothing is
retried and no earlier result is merged in.  --out writes the results,
as one JSON object, to the path given and nowhere else.  --device cuda
(the default) raises without a card.  The transport codec's warm state
lives in a temporary directory for the run, its children's too.

    python -m hydrium_tpu_torch.scale --child cli PNG OUT DEVICE
    python -m hydrium_tpu_torch.scale --child multi ADDR N RANK W H OUT DEVICE

are the children of config5_cli and config5_multi; each prints one JSON
line.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from typing import List, Optional

import numpy as np
import torch

from . import encoder as _encoder
from .bench import _sync, card_line, kernel_counts
from .cli import _peak_rss_mb
from .config import ImageMetadata, SampleFormat
from .device import resolve_device
from .encoder import Encoder
from .utils.stats import EncodeStats

CONFIGS = ("config4", "config5_cli", "config5_multi")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the level-10 container's first bytes (jxl/headers.py LEVEL10_HEADER)
_LEVEL10_HEAD = b"\x00\x00\x00\x0cJXL "
LFG = 2048


class SyntheticImage:
    """Lazy [height, width, 3] uint8 image: smooth band-limited base +
    deterministic per-strip noise, computed on slice access.  Quacks
    like the ndarray encode_image_multihost/Encoder need (shape, dtype,
    2-D slicing) without ever materializing the frame.  The pixels are
    those of scripts/config5_virtual.py's SyntheticImage(size) wherever
    both are defined; the height defaults to the width."""

    def __init__(self, width: int, height: Optional[int] = None) -> None:
        self.shape = (width if height is None else height, width, 3)
        self.dtype = np.dtype(np.uint8)

    def __getitem__(self, key):
        ys, xs = key[0], key[1]
        y0, y1, _ = ys.indices(self.shape[0])
        x0, x1, _ = xs.indices(self.shape[1])
        out = np.empty((max(0, y1 - y0), max(0, x1 - x0), 3), np.uint8)
        # a few rows at a time: the float temporaries of a 2048^2 window
        # would be ~10x the pixels they make, and a process's resident
        # size is what config 5 measures
        for r0 in range(y0, y1, self.ROWS):
            r1 = min(r0 + self.ROWS, y1)
            out[r0 - y0:r1 - y0] = self._rows(r0, r1, x0, x1)
        return out

    ROWS = 256

    @staticmethod
    def _rows(y0: int, y1: int, x0: int, x1: int) -> np.ndarray:
        yy = np.arange(y0, y1, dtype=np.float32)[:, None, None]
        xx = np.arange(x0, x1, dtype=np.float32)[None, :, None]
        phase = np.array([0.0, 1.3, 2.1], np.float32)
        base = 128 + 80 * np.sin(xx / 97.0 + phase) * np.cos(yy / 53.0)
        # coordinate-hashed noise: deterministic for any slice geometry
        # without generating anything outside the requested window
        yu = np.arange(y0, y1, dtype=np.uint32)[:, None, None]
        xu = np.arange(x0, x1, dtype=np.uint32)[None, :, None]
        cu = np.arange(3, dtype=np.uint32)[None, None, :]
        h = (yu * np.uint32(2654435761) ^ xu * np.uint32(0x9E3779B9)
             ^ cu * np.uint32(0x85EBCA6B))
        h ^= h >> np.uint32(15)
        h *= np.uint32(0x2C1B3C6D)
        h ^= h >> np.uint32(12)
        noise = ((h >> np.uint32(8)) & np.uint32(31)).astype(np.float32) - 16.0
        return np.clip(base + noise, 0, 255).astype(np.uint8)


def config4_image(h: int = 4320, w: int = 7680) -> np.ndarray:
    """[h, w, 3] u16, seed 0: a 32768 +- 20000 sinusoid plus N(0, 2500)
    noise (scripts/scale_artifacts.py's config 4 image)."""
    rng = np.random.default_rng(0)
    yy = np.arange(h, dtype=np.float32)[:, None, None]
    xx = np.arange(w, dtype=np.float32)[None, :, None]
    base = 32768 + 20000 * np.sin(xx / 211.0) * np.cos(yy / 97.0)
    return np.clip(base + rng.normal(0, 2500, (h, w, 3)), 0,
                   65535).astype(np.uint16)


def write_png(path: str, image, rows: int = 2048,
              idat_bytes: int = 1 << 20) -> None:
    """An 8-bit RGB PNG of `image` (anything that slices like an
    [H, W, 3] u8 array, SyntheticImage included), written `rows` rows
    at a time: every row unfiltered, zlib level 1, IDAT chunks of at
    most `idat_bytes`.  The frame is never held whole."""
    h, w = image.shape[:2]

    def chunk(f, ctype: bytes, data) -> None:
        f.write(struct.pack(">I", len(data)) + ctype)
        f.write(data)
        f.write(struct.pack(">I", zlib.crc32(data, zlib.crc32(ctype))
                            & 0xFFFFFFFF))

    def idat(f, data: bytes) -> None:
        view = memoryview(data)
        for i in range(0, len(view), idat_bytes):
            chunk(f, b"IDAT", view[i:i + idat_bytes])

    comp = zlib.compressobj(1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        chunk(f, b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        for y0 in range(0, h, rows):
            strip = image[y0:min(y0 + rows, h), 0:w]
            lines = np.zeros((strip.shape[0], 1 + 3 * w), np.uint8)
            lines[:, 1:] = strip.reshape(strip.shape[0], 3 * w)
            idat(f, comp.compress(lines))
        idat(f, comp.flush())
        chunk(f, b"IEND", b"")


def _rss_mb() -> float:
    """This process's resident size now (/proc/self/statm), MiB."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2.0 ** 20


class _PeakRss:
    """The largest resident size seen inside a `with` block, MiB: this
    process's /proc/self/statm read every `interval` seconds on a thread
    of its own, and once at each end.  getrusage's ru_maxrss cannot
    serve a child: Linux carries into it, at exec, the resident size of
    the process that started it, so a child of a large process reports
    that process's size.  A rise and fall shorter than `interval` can be
    missed."""

    def __init__(self, interval: float = 0.005) -> None:
        self.interval = interval
        self.mb = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hyd-rss")

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.mb = max(self.mb, _rss_mb())

    def __enter__(self) -> "_PeakRss":
        self.mb = _rss_mb()
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.mb = max(self.mb, _rss_mb())


def _dispatches(counters) -> int:
    """Dispatches an encode made: packed units, wide retries and the
    cold-start bootstrap."""
    return (counters.get("lfg_packed", 0) + counters.get("wide_retries", 0)
            + counters.get("codec_bootstraps", 0))


def _device_memory(dev: torch.device) -> dict:
    """peak_reserved_mib: the most device memory this process's caching
    allocator reserved since its start or its last reset; graphs: its
    graph cache (ops/graphs.py::graph_stats).  Nothing on the CPU."""
    if dev.type != "cuda":
        return {}
    from .ops.graphs import graph_stats

    return {"peak_reserved_mib": torch.cuda.max_memory_reserved(dev) / 2**20,
            "graphs": graph_stats()}


def _card(dev: torch.device) -> dict:
    return {"device": str(dev), "card": card_line(dev),
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else None)}


def _level10(head: bytes) -> bool:
    return head[:8] == _LEVEL10_HEAD


def _file_facts(path: str) -> dict:
    """Size, sha256 and the level-10 flag of a .jxl file, read in
    pieces."""
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        head = f.read(12)
        digest.update(head)
        for piece in iter(lambda: f.read(1 << 22), b""):
            digest.update(piece)
    return {"bytes": os.path.getsize(path), "sha256": digest.hexdigest(),
            "level10_container": _level10(head),
            "codestream_signature": head[:2] == b"\xff\x0a"}


def _psnr(data: bytes, ref: np.ndarray):
    """(decode PSNR in dB, None), or (None, why) when libjxl does not
    load.  A file libjxl refuses raises."""
    from .utils import djxl

    try:
        djxl._load()
    except OSError as e:
        return None, f"libjxl did not load: {e}"
    dec = djxl.decode(data)
    if dec.shape != ref.shape:
        raise RuntimeError(f"decoded {dec.shape}, want {ref.shape}")
    return float(djxl.psnr(ref, dec)), None


def _rounded_stages(stats) -> dict:
    return {k: round(v, 4) for k, v in stats.stage_seconds.items()}


# -- config 4 -------------------------------------------------------------

def _encode_u16(img: np.ndarray, dev: torch.device, fused_front):
    """One one-frame encode of a u16 image, one send_tile per LF group
    and take_output after each; returns (bytes, Encoder, seconds)."""
    h, w = img.shape[:2]
    enc = Encoder(ImageMetadata(width=w, height=h), device=dev,
                  fused_front=fused_front)
    out = bytearray()
    t0 = time.perf_counter()
    for ty in range((h + LFG - 1) // LFG):
        for tx in range((w + LFG - 1) // LFG):
            enc.send_tile(img[ty * LFG:(ty + 1) * LFG,
                              tx * LFG:(tx + 1) * LFG], tx, ty,
                          sample_fmt=SampleFormat.UINT16)
            out.extend(enc.take_output())
    _sync(dev)
    return bytes(out), enc, time.perf_counter() - t0


def config4(h: int = 4320, w: int = 7680, device="cuda",
            fused_front=None) -> dict:
    """BASELINE config 4 (module docstring).  The warm pass's kernel
    launches are counted; both passes must give the same bytes."""
    dev = resolve_device(device)
    img = config4_image(h, w)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cold, _, dt_cold = _encode_u16(img, dev, fused_front)
    kernel_counts(zero=True)
    data, enc, dt = _encode_u16(img, dev, fused_front)
    launches = kernel_counts()
    if data != cold:
        raise RuntimeError("config4: the warm pass's bytes differ from the "
                           "cold pass's")
    psnr, why = _psnr(data, img / 65535.0)
    counters = dict(enc.stats.counters)
    return {"config": "config4", "what": "8K 16-bit one-frame", "h": h,
            "w": w, **_card(dev), "fused_front": enc.fused_front,
            "mpix_s": h * w / dt / 1e6, "seconds": dt,
            "seconds_cold": dt_cold, "bytes": len(data),
            "bpp": 8 * len(data) / (h * w),
            "sha256": hashlib.sha256(data).hexdigest(),
            "level10_container": _level10(data),
            "codestream_signature": data[:2] == b"\xff\x0a",
            "psnr_db": psnr, "psnr_note": why,
            "stage_seconds": _rounded_stages(enc.stats),
            "counters": counters, "dispatches": _dispatches(counters),
            "launches": launches, **_device_memory(dev)}


# -- config 5: children ---------------------------------------------------

def _warm_up(dev: torch.device) -> float:
    """The device up and one small encode run (kernels loaded, first
    launches made); returns the resident size after it, MiB."""
    img = np.random.default_rng(64).integers(0, 256, (64, 300, 3),
                                             dtype=np.uint8)
    _encoder.encode_image(img, device=dev)
    _sync(dev)
    return _rss_mb()


def _rss_record(base: float, peak: _PeakRss) -> dict:
    """peak_rss_mb: the sampled peak of the encode; rss_growth_mb: that
    less the resident size after the warm-up; ru_maxrss_mb: the kernel's
    own peak figure, which includes the starting process's size."""
    return {"peak_rss_mb": peak.mb, "rss_base_mb": base,
            "rss_growth_mb": peak.mb - base, "ru_maxrss_mb": _peak_rss_mb()}


@contextlib.contextmanager
def made_encoders():
    """Collect every Encoder made inside the block (the CLI keeps its
    own; its stats are read from here)."""
    made: List[Encoder] = []
    real = Encoder.__init__

    def spy(self, *a, **k):
        made.append(self)
        real(self, *a, **k)

    Encoder.__init__ = spy
    try:
        yield made
    finally:
        Encoder.__init__ = real


def _child_cli(png: str, out: str, device: str) -> dict:
    """config5_cli's child: the CLI on the PNG."""
    from . import cli

    dev = resolve_device(device)
    base = _warm_up(dev)
    kernel_counts(zero=True)
    with made_encoders() as made, _PeakRss() as peak:
        t0 = time.perf_counter()
        rc = cli.main([png, out, "--one-frame", "--stats", "--device",
                       device])
        _sync(dev)
        wall = time.perf_counter() - t0
    launches = kernel_counts()
    if rc != 0:
        raise RuntimeError(f"cli.main exit {rc}")
    enc, = made
    counters = dict(enc.stats.counters)
    return {"wall_s": wall, **_rss_record(base, peak), "counters": counters,
            "dispatches": _dispatches(counters),
            "stage_seconds": _rounded_stages(enc.stats),
            "launches": launches, **_device_memory(dev)}


def _child_multi(addr: str, n: str, rank: str, width: str, height: str,
                 out: str, device: str) -> dict:
    """config5_multi's child: join the gloo group, encode this process's
    presets of SyntheticImage(width, height); process 0 writes OUT."""
    from .parallel import multihost

    dev = resolve_device(device)
    base = _warm_up(dev)
    img = SyntheticImage(int(width), int(height))
    multihost.initialize(addr, int(n), int(rank))
    try:
        kernel_counts(zero=True)
        stats = EncodeStats()
        with _PeakRss() as peak:
            t0 = time.perf_counter()
            data = multihost.encode_image_multihost(
                img, device=dev, stats=stats,
                spool_dir=os.path.dirname(out))
            _sync(dev)
            wall = time.perf_counter() - t0
            if data is not None:
                with open(out, "wb") as f:
                    f.write(data)
        launches = kernel_counts()
    finally:
        multihost.shutdown()
    counters = dict(stats.counters)
    return {"rank": int(rank), "wall_s": wall, **_rss_record(base, peak),
            "bytes": 0 if data is None else len(data),
            "counters": counters, "dispatches": _dispatches(counters),
            "stage_seconds": _rounded_stages(stats), "launches": launches,
            **_device_memory(dev)}


def run_processes(cmds: List[List[str]], workdir: str,
                  timeout: float) -> List[dict]:
    """Run each command (python's arguments) at once, from the repo's
    root, with the warm codec in `workdir`; returns the JSON record each
    printed last.  One that fails or outlives `timeout` fails the run;
    every process is stopped whatever happens.  Output goes to files
    in `workdir`: a process blocked on a full pipe while another waits
    for it in a collective would hang both."""
    env = dict(os.environ, HYDRIUM_TORCH_WARM_CACHE=os.path.join(
        workdir, "child_warm.npz"))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, os.environ.get("PYTHONPATH")) if p)
    logs = [(os.path.join(workdir, f"child{i}.out"),
             os.path.join(workdir, f"child{i}.err"))
            for i in range(len(cmds))]
    procs = []
    try:
        for cmd, (lo, le) in zip(cmds, logs):
            with open(lo, "w") as fo, open(le, "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, *cmd], cwd=_REPO, env=env, stdout=fo,
                    stderr=fe))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        recs = []
        for p, (lo, le) in zip(procs, logs):
            if p.returncode != 0:
                with open(le) as f:
                    raise RuntimeError(f"child exit {p.returncode}:\n"
                                       f"{f.read()[-3000:]}")
            with open(lo) as f:
                recs.append(json.loads(f.read().strip().splitlines()[-1]))
        return recs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _children(argvs: List[List[str]], workdir: str,
              timeout: float) -> List[dict]:
    """This module's --child mode, once per argv (run_processes)."""
    return run_processes([["-m", "hydrium_tpu_torch.scale", "--child", *a]
                          for a in argvs], workdir, timeout)


# -- config 5 -------------------------------------------------------------

def _prepare_children(dev: torch.device) -> None:
    """Build the kernels here, so that children that start together only
    load the library."""
    if dev.type == "cuda":
        from .ops import _kernels

        _kernels.build()


def config5_cli(width: int = 16384, height: Optional[int] = None,
                device="cuda", timeout: float = 3600) -> dict:
    """BASELINE config 5 through the CLI from a PNG on disk (module
    docstring)."""
    height = width if height is None else height
    dev = resolve_device(device)
    _prepare_children(dev)
    with tempfile.TemporaryDirectory(prefix="hyd_scale_") as td:
        png, out = os.path.join(td, "in.png"), os.path.join(td, "out.jxl")
        t0 = time.perf_counter()
        write_png(png, SyntheticImage(width, height))
        t_png = time.perf_counter() - t0
        rec, = _children([["cli", png, out, device]], td, timeout)
        facts = _file_facts(out)
        png_mb = os.path.getsize(png) / 2.0 ** 20
    raw = 3 * width * height
    return {"config": "config5_cli", "what": "streaming CLI from a PNG",
            "w": width, "h": height, "mpix": width * height / 1e6,
            **_card(dev), "mpix_s": width * height / rec["wall_s"] / 1e6,
            "seconds": rec["wall_s"], **facts,
            "bpp": 8 * facts["bytes"] / (width * height),
            "raw_mb": raw / 2.0 ** 20,
            "rss_growth_share": rec["rss_growth_mb"] * 2.0 ** 20 / raw,
            "png_write_s": t_png, "input_png_mb": png_mb,
            **{k: rec[k] for k in ("peak_rss_mb", "rss_base_mb",
                                   "rss_growth_mb", "ru_maxrss_mb",
                                   "counters",
                                   "dispatches", "stage_seconds",
                                   "launches", "peak_reserved_mib", "graphs")
               if k in rec}}


def _streaming_reference(img, dev: torch.device, spool_dir: str) -> dict:
    """The single-process streaming Encoder on `dev`, fed 2048-row
    strips of img with a spool directory, output drained in pieces:
    (sha256, bytes, seconds)."""
    h, w = img.shape[:2]
    enc = Encoder(ImageMetadata(width=w, height=h), device=dev,
                  streaming=True, spool_dir=spool_dir)
    digest, n = hashlib.sha256(), 0
    t0 = time.perf_counter()
    for ty in range((h + LFG - 1) // LFG):
        strip = img[ty * LFG:(ty + 1) * LFG, 0:w]
        for tx in range((w + LFG - 1) // LFG):
            enc.send_tile(strip[:, tx * LFG:(tx + 1) * LFG], tx, ty)
        for piece in enc.iter_output():
            digest.update(piece)
            n += len(piece)
    _sync(dev)
    return {"sha256": digest.hexdigest(), "bytes": n,
            "seconds": time.perf_counter() - t0}


def free_addr() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def config5_multi(width: int = 16384, height: Optional[int] = None,
                  processes: int = 2, device="cuda",
                  reference: Optional[dict] = None,
                  timeout: float = 3600) -> dict:
    """BASELINE config 5 over `processes` gloo processes on one device
    (module docstring).  reference: {"sha256", "bytes"} of a file of the
    same pixels (config5_cli's result); None runs the single-process
    streaming Encoder here."""
    height = width if height is None else height
    dev = resolve_device(device)
    _prepare_children(dev)
    with tempfile.TemporaryDirectory(prefix="hyd_scale_") as td:
        out = os.path.join(td, "multi.jxl")
        addr = free_addr()
        t0 = time.perf_counter()
        recs = _children(
            [["multi", addr, str(processes), str(r), str(width), str(height),
              out, device] for r in range(processes)], td, timeout)
        wall = time.perf_counter() - t0
        facts = _file_facts(out)
        if reference is None:
            reference = dict(_streaming_reference(
                SyntheticImage(width, height), dev, td),
                source="single-process streaming Encoder")
        else:
            reference = dict(reference, source="config5_cli")
    raw = 3 * width * height
    for r in recs:
        r["rss_growth_share"] = r["rss_growth_mb"] * 2.0 ** 20 / raw
    launches = {k: sum(r["launches"][k] for r in recs)
                for k in recs[0]["launches"]}
    return {"config": "config5_multi",
            "what": f"{processes} processes over gloo, lazy strip input",
            "w": width, "h": height, "mpix": width * height / 1e6,
            "processes": processes, **_card(dev),
            "mpix_s": width * height / max(r["wall_s"] for r in recs) / 1e6,
            "wall_with_start_s": wall, **facts,
            "byte_identical": facts["sha256"] == reference["sha256"],
            "reference": reference, "raw_mb": raw / 2.0 ** 20,
            "dispatches": sum(r["dispatches"] for r in recs),
            "launches": launches, "per_process": recs}


# -- command line ---------------------------------------------------------

def _child_main(argv: List[str]) -> int:
    kind, args = argv[0], argv[1:]
    rec = _child_cli(*args) if kind == "cli" else _child_multi(*args)
    print(json.dumps(rec), flush=True)
    return 0


def run(only, size: Optional[int], height: Optional[int], quick: bool,
        device: str, emit=print) -> tuple:
    """The configs of `only` (all when empty), in CONFIGS order; emit()
    gets one JSON line each.  Returns (results by config, exit code)."""
    results, rc = {}, 0
    c4 = (height or (1080 if quick else 4320),
          size or (1920 if quick else 7680))
    w5 = size or (4096 if quick else 16384)
    h5 = height or w5
    for name in CONFIGS:
        if only and name not in only:
            continue
        try:
            if name == "config4":
                res = config4(*c4, device=device)
            elif name == "config5_cli":
                res = config5_cli(w5, h5, device=device)
            else:
                cli_res = results.get("config5_cli", {})
                ref = ({k: cli_res[k] for k in ("sha256", "bytes")}
                       if "sha256" in cli_res else None)
                res = config5_multi(w5, h5, device=device, reference=ref)
                if not res["byte_identical"]:
                    raise RuntimeError(
                        f"config5_multi: process 0's file ({res['sha256']})"
                        f" differs from the reference "
                        f"({res['reference']['sha256']})")
        except Exception as e:   # noqa: BLE001 - reported, then rc 1
            res, rc = {"config": name,
                       "error": f"{type(e).__name__}: {e}"}, 1
        results[name] = res
        emit(json.dumps(res))
    return results, rc


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        return _child_main(argv[1:])
    ap = argparse.ArgumentParser(prog="python -m hydrium_tpu_torch.scale",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", action="append", choices=CONFIGS, default=[])
    ap.add_argument("--size", type=int, default=None,
                    help="frame width (config 4: 7680, config 5: 16384)")
    ap.add_argument("--height", type=int, default=None,
                    help="frame height (config 4: 4320, config 5: the "
                         "width)")
    ap.add_argument("--quick", action="store_true",
                    help="config 4 at 1920x1080, config 5 at 4096x4096")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="write the results as one JSON object here")
    args = ap.parse_args(argv)
    old_cache = _encoder._WARM_CACHE
    with tempfile.TemporaryDirectory(prefix="hyd_scale_") as tmp:
        _encoder.reset_warm_state(os.path.join(tmp, "warm.npz"))
        try:
            results, rc = run(args.only, args.size, args.height, args.quick,
                              args.device,
                              emit=lambda line: print(line, flush=True))
        finally:
            _encoder.reset_warm_state(old_cache)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
