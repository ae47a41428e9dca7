"""Throughput bench of the port on one device: the twin of the JAX
package's root bench.py, with its keys and its fixtures.

    python -m hydrium_tpu_torch.bench [iters] [--device-plane]
                                      [--device cuda|cpu] [--crop HxW]

End to end (the default, `iters` 4): 3840x2160 RGB8 encodes, pixels in
RAM to .jxl bytes on the host, through Encoder.send_tile per 2048^2 LF
group (one-frame) or Encoder.send_tile_batch per row of 256^2 tiles
(tiled), take_output after each call.  The host clock starts once the
Encoder is made and stops after the last take_output and a device
synchronize.  Rows, in bench.py's order and with its warm-ups: smooth
one-frame, noisy one-frame (the headline `value`), noisy tiled, noisy
tiled with the fused front (`tiled_fused`, which launches all three
kernels), photo one-frame.  The other rows take the default front,
which HYDRIUM_PALLAS=1 makes the fused one for every row.

Per row (the noisy one-frame row's keys start with `value_`, and its
bits per pixel are `wire_bpp`): Mpix/s of the best of its encodes
(`<row>_mpix_s`, `value`) and of their median (`_median_mpix_s`); the
spread of the walls, (max - min) / median (`_spread`), their
interquartile range over the median (`_iqr`), their coefficient of
variation (`_cv`) and the runs per side that a 5% difference between
two medians needs at that variation (`_runs_for_5pct`, normal
approximation, two-sided 5% level, power 0.8); the median seconds the
calling thread was blocked (`_fetch_wait_s`); the bits per pixel that
crossed the link on the best encode (`_wire_bpp`: h2d_raw_bytes plus
fetched_words); and the device idle share of one more encode under
torch.profiler, 1 - busy / wall with busy the device events' self time
(`_idle_share`; null on the CPU, which has no device to be idle).  Every
encode of a row must give the same bytes, and none may bootstrap the
transport codec.  One cumulative JSON line is printed after each row;
the last holds them all.  The stage breakdown of each row's best encode
goes to stderr, and its timeline too when HYDRIUM_BENCH_TIMELINE=1.

--device-plane (`iters` 50): the packed pipeline alone on one LF group
of the noisy image (2048^2, or --crop) already on the device, in three
variants: `torch` (ops/packed.py::encode_lfg_packed, default front),
`fused` (the same with the fused front: all three kernels) and
`unpacked` (ops/front.py::encode_lfg); on a card also `torch_graph` and
`fused_graph`, the first two replayed from their CUDA graphs
(ops/graphs.py, as an Encoder dispatches; the first call runs eagerly,
the second captures).  Two untimed calls start each variant.
Per variant: `_ms_per_lfg` and `_mpix_s` from `iters` back-to-back
calls between CUDA events (the host clock on the CPU); `_per_call_ms`,
the median of single calls each ending in a synchronize;
`_queued_ms_per_lfg`, calls enqueued and one word of the last result
read back.  For `fused` and `fused_graph` also the kernels' launches
per call (the wrappers' counters); for `fused` the five device
operations with the most self time per call, from one torch.profiler
pass; for the graph variants `_clone_ms`, the device time of the clone
of one payload that each replay makes (back to back between CUDA
events), and `graphs`, graph_stats() after the timing.

--device defaults to cuda and raises without a card; the CPU runs only
when asked, and its times are the CPU's.  --crop cuts every fixture to
its top-left HxW after generating it.  The transport codec's warm state
lives in a temporary directory for the run.  A failure raises.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import encoder as _encoder
from .config import ImageMetadata, SampleFormat
from .device import resolve_device
from .encoder import Encoder
from .jxl.tokcode import TokenCodec
from .ops import graphs, tables
from .ops.bitpack import pack_chunks
from .ops.front import FrontEnd, encode_lfg
from .ops.frontend import frontend_groups, frontend_tokens
from .ops.packed import encode_lfg_packed
from .ops.transport import transport_prep

# the kernels' wrappers, whose .launches count the launches
KERNELS = {"transport_prep": transport_prep, "chunk_pack": pack_chunks,
           "frontend_tokens": frontend_tokens,
           "frontend_groups": frontend_groups}
# z(0.975) + z(0.8): a two-sided 5% test with power 0.8
_Z = 1.959964 + 0.841621
# the end-to-end rows, in the order they run
ROWS = ("smooth", "value", "tiled", "tiled_fused", "photo")
_FIGURES = ("mpix_s", "wire_bpp", "median_mpix_s", "spread", "iqr", "cv",
            "runs_for_5pct", "fetch_wait_s", "idle_share", "walls_s")


def make_4k_noisy(seed=0):
    rng = np.random.default_rng(seed)
    h, w = 2160, 3840
    yy = np.arange(h, dtype=np.float32)[:, None, None]
    xx = np.arange(w, dtype=np.float32)[None, :, None]
    phase = np.array([0.0, 1.3, 2.1], np.float32)
    base = 128 + 80 * np.sin(xx / 97.0 + phase) * np.cos(yy / 53.0 - phase)
    noise = rng.normal(0, 24, (h, w, 3)).astype(np.float32)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def make_4k_smooth():
    """Smooth gradient content (the reference's fast case: few nonzero
    HF coefficients)."""
    h, w = 2160, 3840
    yy = np.arange(h, dtype=np.float32)[:, None, None]
    xx = np.arange(w, dtype=np.float32)[None, :, None]
    phase = np.array([0.0, 1.3, 2.1], np.float32)
    base = 128 + 80 * np.sin(xx / 971.0 + phase) * np.cos(yy / 533.0 - phase)
    return np.clip(base, 0, 255).astype(np.uint8)


def make_4k_photo(seed=3):
    """Photographic-statistics content: ~1/f^2 luminance power spectrum
    (the classic natural-image model), correlated low-amplitude chroma,
    and hard region edges from a thresholded low-frequency field.  The
    noise and smooth extremes are both degenerate for transport
    decisions (entropy floor / near-zero payload); this one is the
    regime of photographic PNGs."""
    h, w = 2160, 3840
    rng = np.random.default_rng(seed)

    def pink(exponent):
        fy = np.fft.fftfreq(h)[:, None]
        fx = np.fft.rfftfreq(w)[None, :]
        f = np.sqrt(fy * fy + fx * fx)
        f[0, 0] = 1.0
        spec = (rng.normal(size=(h, w // 2 + 1))
                + 1j * rng.normal(size=(h, w // 2 + 1))) / f ** exponent
        x = np.fft.irfft2(spec, s=(h, w))
        x -= x.mean()
        return x / (np.abs(x).std() + 1e-9)

    luma = pink(1.1)
    # hard edges: a thresholded very-low-frequency field shifts regions
    edges = np.where(pink(1.8) > 0.3, 0.9, 0.0)
    c1, c2 = pink(1.3), pink(1.3)
    img = np.stack([luma + 0.25 * c1 + edges,
                    luma + edges,
                    luma + 0.25 * c2 + edges], axis=-1)
    img = (img - img.min()) / (img.max() - img.min())
    return np.clip(img * 255.0 + rng.normal(0, 1.2, img.shape),
                   0, 255).astype(np.uint8)


def parse_crop(text: str) -> Tuple[int, int]:
    """"HxW" -> (H, W), both positive."""
    try:
        h, w = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"crop {text!r}: want HxW") from None
    if h < 1 or w < 1:
        raise argparse.ArgumentTypeError(f"crop {text!r}: want HxW > 0")
    return h, w


def _cropped(img: np.ndarray, crop) -> np.ndarray:
    return img if crop is None else img[:crop[0], :crop[1]]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line(device: torch.device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them (None on
    the CPU)."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def kernel_counts(zero: bool = False) -> Dict[str, int]:
    """The wrappers' launch counts (set to 0 first when `zero`)."""
    if zero:
        for fn in KERNELS.values():
            fn.launches = 0
    return {k: fn.launches for k, fn in KERNELS.items()}


def _profile(run: Callable[[], None], device: torch.device):
    """One torch.profiler pass over run(); returns (key_averages, wall
    seconds).  On a card a trace that saw no device time is taken once
    more, and a second such trace raises."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    for _attempt in range(2):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            _sync(device)
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        if device.type != "cuda" or _busy_us(ka) > 0:
            return ka, wall
    raise RuntimeError("torch.profiler saw no device time in two traces")


def _device_events(ka):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in ka if e.device_type == cuda]


def _busy_us(ka) -> float:
    """The device events' self time (the profiler table's "Self CUDA time
    total"), in us."""
    return sum(e.self_device_time_total for e in _device_events(ka))


# -- device plane -----------------------------------------------------

def plane_variants(device="cuda", crop=None) -> Dict[str, Callable]:
    """The device plane's calls on one LF group of the noisy image
    (2048^2, or its top-left crop), inputs already on `device`:
    {"torch", "fused", "unpacked"}, and on a card "torch_graph" and
    "fused_graph" -> a function that runs one call and returns its
    result (the combined payload; encode_lfg's dict)."""
    dev = resolve_device(device)
    h, w = crop or (2048, 2048)
    if h > 2048 or w > 2048:
        raise ValueError(f"device plane crop {h}x{w}: an LF group is at "
                         "most 2048x2048")
    # the Encoder's buffers: 256-multiples, the upload bucketed to 32
    buf_h, buf_w = ((h + 255) >> 8) << 8, ((w + 255) >> 8) << 8
    stage = np.zeros((min(buf_h, ((h + 31) >> 5) << 5),
                      min(buf_w, ((w + 31) >> 5) << 5), 3), np.uint8)
    stage[:h, :w] = make_4k_noisy()[:h, :w]
    px = torch.as_tensor(stage, device=dev)
    G = (buf_h >> 8) * (buf_w >> 8)
    presets = torch.zeros(G, dtype=torch.int32, device=dev)
    num_clusters = int(tables.hf_cluster_map(1).max()) + 1
    lens, codes, _lut = TokenCodec().tables()
    lens_d = torch.as_tensor(lens.astype(np.int32), device=dev)
    codes_d = torch.as_tensor(codes.astype(np.int32), device=dev)
    front = FrontEnd.from_tables().to(dev)
    kw = dict(buf_h=buf_h, buf_w=buf_w, linear_light=False,
              sample_kind="uint8")

    def packed(fused, run=encode_lfg_packed):
        return lambda: run(front, px, h, w, presets, lens_d, codes_d,
                           tok_classes=num_clusters, fused=fused, **kw)

    variants = {"torch": packed(False), "fused": packed(True),
                "unpacked": lambda: encode_lfg(front, px, h, w, presets,
                                               num_clusters=num_clusters,
                                               **kw)}
    if dev.type == "cuda":
        variants["torch_graph"] = packed(False, graphs.encode_lfg_packed)
        variants["fused_graph"] = packed(True, graphs.encode_lfg_packed)
    return variants


def _first_word(result) -> torch.Tensor:
    """One word of a variant's result, on the host."""
    t = result["valid_len"] if isinstance(result, dict) else result
    return t[:1].cpu()


def _time_variant(fn, iters: int, device: torch.device) -> dict:
    """ms per call back to back, the median single call, and the queued
    cross-check, for one device-plane variant, after two untimed calls
    (a graph variant's eager first dispatch and its capture)."""
    fn()
    fn()
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        back_to_back = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        back_to_back = (time.perf_counter() - t0) * 1e3 / iters
    single = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        single.append((time.perf_counter() - t0) * 1e3)
    nq = max(iters // 5, 2)
    t0 = time.perf_counter()
    for _ in range(nq):
        r = fn()
    _first_word(r)
    queued = (time.perf_counter() - t0) * 1e3 / nq
    return {"ms_per_lfg": back_to_back, "per_call_ms":
            statistics.median(single), "queued_ms_per_lfg": queued}


def device_plane(iters: int = 50, device="cuda", crop=None) -> dict:
    """Time the three device-plane variants (module docstring); returns
    the result dict."""
    dev = resolve_device(device)
    variants = plane_variants(dev, crop)
    h, w = crop or (2048, 2048)
    out = {"metric": f"device-plane packed pipeline, {h}x{w} LF group",
           "unit": "Mpixels/s", "device": str(dev), "card": card_line(dev),
           "iters": iters}
    for name, fn in variants.items():
        kernel_counts(zero=True)
        t = _time_variant(fn, iters, dev)
        out[f"{name}_ms_per_lfg"] = t["ms_per_lfg"]
        out[f"{name}_mpix_s"] = h * w / t["ms_per_lfg"] / 1e3
        out[f"{name}_per_call_ms"] = t["per_call_ms"]
        out[f"{name}_queued_ms_per_lfg"] = t["queued_ms_per_lfg"]
        if name.startswith("fused"):
            # the timing made 2 + 2 * iters + max(iters // 5, 2) calls
            calls = 2 + 2 * iters + max(iters // 5, 2)
            out[f"{name}_launches_per_call"] = {
                k: n / calls for k, n in kernel_counts().items()}
        if name.endswith("_graph"):
            out[f"{name}_clone_ms"] = _clone_ms(fn(), iters)
        if name != "fused":
            continue
        reps = 5

        def run():
            for _ in range(reps):
                fn()

        ka, _wall = _profile(run, dev)
        if dev.type == "cuda":
            events = _device_events(ka)
            key = "self_device_time_total"
            out["fused_device_busy_ms_per_call"] = _busy_us(ka) / 1e3 / reps
        else:
            events = list(ka)
            key = "self_cpu_time_total"
        top = sorted(events, key=lambda e: -getattr(e, key))[:5]
        out["fused_top_ops"] = [{"name": e.key, "ms_per_call":
                                 getattr(e, key) / 1e3 / reps} for e in top]
        out["fused_top_ops_by"] = key
    if dev.type == "cuda":
        out["graphs"] = graphs.graph_stats()
    return out


def _clone_ms(payload: torch.Tensor, iters: int) -> float:
    """Device ms of one clone of a payload, as a graph's replay makes
    it: `iters` back to back between CUDA events."""
    payload.clone()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        payload.clone()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- end to end ---------------------------------------------------------

def _encode(img: np.ndarray, tile_shift: int, device: torch.device,
            fused_front) -> Tuple[bytes, object, float]:
    """One encode as bench.py feeds it; returns (bytes, EncodeStats, wall
    seconds from the Encoder's first tile to its last output on the
    host, device synchronized)."""
    h, w = img.shape[:2]
    meta = ImageMetadata(width=w, height=h, tile_size_shift_x=tile_shift,
                         tile_size_shift_y=tile_shift)
    ts = 2048 if tile_shift < 0 else meta.tile_width
    enc = Encoder(meta, device=device, fused_front=fused_front)
    if os.environ.get("HYDRIUM_BENCH_TIMELINE", "0") == "1":
        enc.stats.enable_timeline()
    out = bytearray()
    t0 = time.perf_counter()
    for ty in range((h + ts - 1) // ts):
        if tile_shift < 0:
            for tx in range((w + ts - 1) // ts):
                enc.send_tile(img[ty * ts:(ty + 1) * ts,
                                  tx * ts:(tx + 1) * ts], tx, ty,
                              sample_fmt=SampleFormat.UINT8)
                out.extend(enc.take_output())
        else:
            entries = [(img[ty * ts:(ty + 1) * ts, tx * ts:(tx + 1) * ts],
                        tx, ty) for tx in range((w + ts - 1) // ts)]
            enc.send_tile_batch(entries, sample_fmt=SampleFormat.UINT8)
            out.extend(enc.take_output())
    _sync(device)
    return bytes(out), enc.stats, time.perf_counter() - t0


def wire_bpp(stats, pixels: int) -> float:
    """Bits per pixel that crossed the link: the raw pixel uploads and
    the words copied back (the port has no packed pixel upload)."""
    c = stats.counters
    return 8.0 * (c.get("h2d_raw_bytes", 0)
                  + 4 * c.get("fetched_words", 0)) / pixels


def _measure(img: np.ndarray, iters: int, label: str, tile_shift: int = -1,
             device="cuda", fused_front=None) -> Tuple[dict, bytes]:
    """`iters` encodes of img (one-frame, or tiled for tile_shift >= 0)
    and one more under torch.profiler on a card; returns (figures, the
    encoded bytes)."""
    dev = resolve_device(device)
    pixels = img.shape[0] * img.shape[1]
    walls, waits, data, best = [], [], None, None
    for i in range(iters):
        got, stats, wall = _encode(img, tile_shift, dev, fused_front)
        print(f"bench[{label}]: iter {i}: {wall:.4f}s "
              f"({pixels / wall / 1e6:.3f} Mpix/s)", file=sys.stderr,
              flush=True)
        if stats.counters.get("codec_bootstraps", 0):
            raise RuntimeError(f"bench[{label}]: a timed encode bootstrapped "
                               "the transport codec")
        if data is not None and got != data:
            raise RuntimeError(f"bench[{label}]: encode {i} gave other bytes")
        if data is None or wall < min(walls):
            best = stats
        data = got
        walls.append(wall)
        waits.append(stats.stage_seconds.get("fetch_wait", 0.0))
    if not data.startswith(b"\xff\x0a"):
        raise RuntimeError(f"bench[{label}]: no JPEG XL signature: "
                           f"{data[:8].hex()}")
    med = statistics.median(walls)
    cv, iqr = 0.0, 0.0
    if iters > 1:
        cv = statistics.stdev(walls) / statistics.mean(walls)
        q1, _q2, q3 = statistics.quantiles(walls, n=4, method="inclusive")
        iqr = (q3 - q1) / med
    fig = {"mpix_s": pixels / min(walls) / 1e6,
           "median_mpix_s": pixels / med / 1e6,
           "spread": (max(walls) - min(walls)) / med, "iqr": iqr, "cv": cv,
           "runs_for_5pct": math.ceil(2 * (_Z * cv / 0.05) ** 2),
           "fetch_wait_s": statistics.median(waits),
           "wire_bpp": wire_bpp(best, pixels), "idle_share": None,
           "walls_s": walls}
    print(f"bench[{label}]: stage breakdown (best iter):\n" + best.summary(),
          file=sys.stderr, flush=True)
    if best.events is not None:
        print(f"bench[{label}]: timeline (best iter):\n" + best.timeline(),
              file=sys.stderr, flush=True)
    if dev.type == "cuda":
        traced = []
        ka, wall = _profile(lambda: traced.append(
            _encode(img, tile_shift, dev, fused_front)[0]), dev)
        if traced[0] != data:
            raise RuntimeError(f"bench[{label}]: the traced encode gave "
                               "other bytes")
        fig["idle_share"] = 1 - _busy_us(ka) / 1e6 / wall
    return fig, data


def row_keys(row: str) -> Dict[str, str]:
    """A row's figure -> its key in the result, bench.py's where it has
    one: the headline row's Mpix/s is `value` and its bits per pixel
    `wire_bpp`, its other figures `value_*`."""
    keys = {k: f"{row}_{k}" for k in _FIGURES}
    if row == "value":
        keys.update(mpix_s="value", wire_bpp="wire_bpp")
    return keys


def rows(iters: int = 4, device="cuda", crop=None,
         emit: Optional[Callable[[dict], None]] = None):
    """bench.py main()'s rows, in its order with its warm-ups, plus
    tiled_fused.  emit(result) is called after each row.  Returns
    (result, {row: bytes})."""
    dev = resolve_device(device)
    fused = None            # as HYDRIUM_PALLAS says
    img = _cropped(make_4k_noisy(), crop)
    smooth = _cropped(make_4k_smooth(), crop)
    result = {"metric": "4K RGB8 one-frame encode throughput",
              "value": 0.0, "unit": "Mpixels/s", "device": str(dev),
              "card": card_line(dev), "iters": iters,
              "crop": None if crop is None else f"{crop[0]}x{crop[1]}"}
    files = {}

    def row(name, pixels, n, shift=-1, fused_front=fused):
        fig, files[name] = _measure(pixels, n, name, shift, dev, fused_front)
        result.update({key: fig[k] for k, key in row_keys(name).items()})
        if emit is not None:
            emit(result)

    def warm(pixels, shift=-1, fused_front=fused):
        _encode(pixels, shift, dev, fused_front)

    # each content once first: the cold codec's bootstrap, and the
    # first use of each buffer shape
    print("bench: warmup...", file=sys.stderr, flush=True)
    warm(img)
    warm(smooth)
    # smooth right after its warm-up: the codec is smooth-trained here,
    # as in any steady smooth workload
    row("smooth", smooth, max(3, iters // 2 + 1))
    # one noisy encode re-adapts the codec first
    warm(img)
    row("value", img, iters)
    # 256^2 tiles, one row of tiles per send_tile_batch call
    warm(img, 0)
    row("tiled", img, max(2, iters // 2), 0)
    warm(img, 0, True)
    row("tiled_fused", img, max(2, iters // 2), 0, True)
    photo = _cropped(make_4k_photo(), crop)
    warm(photo)
    row("photo", photo, max(2, iters // 2))
    return result, files


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hydrium_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("iters", nargs="?", type=int, default=None)
    ap.add_argument("--device-plane", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--crop", type=parse_crop, default=None,
                    help="HxW: cut every fixture to its top-left HxW")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    old_cache = _encoder._WARM_CACHE
    with tempfile.TemporaryDirectory(prefix="hyd_bench_") as tmp:
        _encoder.reset_warm_state(os.path.join(tmp, "warm.npz"))
        try:
            if args.device_plane:
                print(json.dumps(device_plane(args.iters or 50, dev,
                                              args.crop)), flush=True)
            else:
                rows(args.iters or 4, dev, args.crop,
                     emit=lambda r: print(json.dumps(r), flush=True))
        finally:
            _encoder.reset_warm_state(old_cache)
    return 0


if __name__ == "__main__":
    sys.exit(main())
