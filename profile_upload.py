#!/usr/bin/env python3
"""Time the device plane's pixel upload of one 2048x2048 u8 LF group on
the card against the host pack that PXPACK would put in its place.

    python3 profile_upload.py [--reps 20]

The upload is the one _TorchDispatch makes (hydrium_tpu_torch/
encoder.py): the caller's pixels copied into a pinned staging buffer
(timed on the host clock), then stage.to(device, non_blocking=True)
timed between CUDA events.  The pack is hydrium_tpu.jxl.native.px_pack2
with the defaults hydrium_tpu's dispatch uses, and once more forced
(cap_ratio 2.0, which packs whatever the content), on the same pixels
on the host clock.  px_pack2 is numpy and ctypes and needs no jax: this
script holds the two packages side by side and is no part of the port.
PXPACK can save at most the upload less the device unpack, and costs
the pack on the dispatching thread.

Content: LF group (0, 0) of chip_smoke.make_4k (sinusoid plus noise,
bench.py's make_4k_noisy) and of a smooth copy of bench.py's
make_4k_smooth.  Every time is the median of --reps runs after one
warm-up.  Prints the card's name and power limit, then one JSON line.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def make_4k_smooth() -> np.ndarray:
    """bench.py's make_4k_smooth: a slow sinusoid, no noise."""
    h, w = 2160, 3840
    yy = np.arange(h, dtype=np.float32)[:, None, None]
    xx = np.arange(w, dtype=np.float32)[None, :, None]
    phase = np.array([0.0, 1.3, 2.1], np.float32)
    base = 128 + 80 * np.sin(xx / 971.0 + phase) * np.cos(yy / 533.0 - phase)
    return np.clip(base, 0, 255).astype(np.uint8)


def time_upload(px: np.ndarray, reps: int) -> dict:
    """Staging copy (host clock) and pinned H2D copy (CUDA events) of
    one LF group, as _TorchDispatch makes them."""
    import torch

    h, w = px.shape[:2]
    stage_ms, h2d_ms = [], []
    for i in range(reps + 1):
        t0 = time.perf_counter()
        stage = torch.zeros((h, w, 3), dtype=torch.uint8, pin_memory=True)
        stage.numpy()[:h, :w] = px
        t1 = time.perf_counter()
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        dev = stage.to("cuda", non_blocking=True)
        end.record()
        end.synchronize()
        assert dev.shape == stage.shape
        if i:
            stage_ms.append((t1 - t0) * 1e3)
            h2d_ms.append(start.elapsed_time(end))
    h2d = statistics.median(h2d_ms)
    return {"bytes": px.nbytes, "stage_ms": statistics.median(stage_ms),
            "h2d_ms": h2d, "h2d_gb_per_s": px.nbytes / h2d / 1e6,
            "h2d_ms_min_max": [min(h2d_ms), max(h2d_ms)]}


def time_pack(px: np.ndarray, reps: int, **kw) -> dict:
    from hydrium_tpu.jxl import native

    assert native.available(), "the JAX package's native plane did not build"
    times, res = [], None
    for i in range(reps + 1):
        t0 = time.perf_counter()
        res = native.px_pack2(px, **kw)
        dt = time.perf_counter() - t0
        if i:
            times.append(dt * 1e3)
    packed = (None if res is None else
              sum(a.nbytes for a in res[1:] if isinstance(a, np.ndarray)))
    return {"ms": statistics.median(times),
            "ms_min_max": [min(times), max(times)],
            "kind": None if res is None else res[0],
            "packed_bytes": packed}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_upload: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from chip_smoke import make_4k

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    out = {"card": smi, "torch": torch.__version__, "cpus": os.cpu_count()}
    for name, img in (("noisy", make_4k()), ("smooth", make_4k_smooth())):
        px = np.ascontiguousarray(img[:2048, :2048])
        row = {"upload": time_upload(px, args.reps),
               "px_pack2_default": time_pack(px, args.reps),
               "px_pack2_forced": time_pack(px, args.reps, cap_ratio=2.0)}
        out[name] = row
        print(f"{name} 2048x2048 u8 on {smi}: upload {row['upload']}; "
              f"px_pack2 default {row['px_pack2_default']}; forced "
              f"{row['px_pack2_forced']}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
