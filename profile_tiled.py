#!/usr/bin/env python3
"""Where the time of a tiled 4K encode goes, on one CUDA card.

    python3 profile_tiled.py [--reps 3] [--detail PATH]

The encode is chip_smoke.py's tiled phase: a 3840x2160 u8 image (seed
0) in 256^2 tiles, one row per Encoder.send_tile_batch call, with the
fused front and with the unfused one.  The transport codec's warm state
goes to a temporary directory.  After two warm-up encodes per front it
prints:
- the warm wall of each front, `reps` times, alternating, and with it
  the time the calling thread spent blocked on its worker threads
  (stage fetch_wait); the same for the fused front with
  HYDRIUM_INFLIGHT=0 (every unit drained as soon as it is dispatched:
  no overlap), and for the one-frame encode of the same image with the
  default window and with HYDRIUM_INFLIGHT=0;
- per front, and for the fused front with HYDRIUM_INFLIGHT=0, under
  torch.profiler: the profiled wall, the device busy time (the device
  events' self time, the table's "Self CUDA time total") and the device
  idle share 1 - busy / wall;
- for one more fused encode: the seconds spent in the functions that
  carry the calling thread's time (the unit drains, which block on the
  workers; the chunk dispatches; the codec's table rebuild) and the
  fetch threads' (fetch, the payload parse), each wrapped in a timer,
  and the encode's stage seconds (EncodeStats, summed over threads).
  cProfile is not used: on Python 3.12 it sees the worker threads too
  and mixes their call stacks.
The last line is one JSON object of these numbers.  --detail writes the
profiler's kernel tables to PATH.
"""

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time


def _timed(owner, name: str, totals: dict, key: str):
    """Wrap owner.name so that each call adds its seconds to totals[key];
    returns a function that puts the original back."""
    orig = getattr(owner, name)
    totals[key] = 0.0
    lock = threading.Lock()     # some of these run on worker threads

    @functools.wraps(orig)
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            with lock:
                totals[key] += time.perf_counter() - t0

    setattr(owner, name, wrapper)
    return lambda: setattr(owner, name, orig)


def _run(encode, img, fused: bool, inflight):
    """One encode with HYDRIUM_INFLIGHT set to `inflight` (None: unset);
    returns (wall seconds, seconds the calling thread was blocked)."""
    import hydrium_tpu_torch as H

    os.environ.pop("HYDRIUM_INFLIGHT", None)
    if inflight is not None:
        os.environ["HYDRIUM_INFLIGHT"] = str(inflight)
    try:
        st = H.EncodeStats()
        t0 = time.perf_counter()
        encode(img, fused, st)
        return (time.perf_counter() - t0,
                st.stage_seconds.get("fetch_wait", 0.0))
    finally:
        os.environ.pop("HYDRIUM_INFLIGHT", None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--detail", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_tiled: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS
    import hydrium_tpu_torch as H
    from hydrium_tpu_torch import encoder as torch_encoder

    scratch = tempfile.TemporaryDirectory(prefix="hyd_profile_")
    torch_encoder.reset_warm_state(os.path.join(scratch.name, "warm.npz"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    img = CS.make_4k()
    for fused in (True, False, True, False):
        CS.encode_tiled(img, fused, H.EncodeStats())

    CS.encode_one_frame(img, True, H.EncodeStats())
    # (label, encode, fused, HYDRIUM_INFLIGHT), taken in turns
    cases = [("fused", CS.encode_tiled, True, None),
             ("fused_inflight_0", CS.encode_tiled, True, 0),
             ("unfused", CS.encode_tiled, False, None),
             ("one_frame_fused", CS.encode_one_frame, True, None),
             ("one_frame_fused_inflight_0", CS.encode_one_frame, True, 0)]
    walls = {c[0]: [] for c in cases}
    blocked = {c[0]: [] for c in cases}
    for _ in range(args.reps):
        for label, encode, fused, inflight in cases:
            wall, wait = _run(encode, img, fused, inflight)
            walls[label].append(wall)
            blocked[label].append(wait)
    print(f"warm wall s: {walls}", flush=True)
    print(f"calling thread blocked s (fetch_wait): {blocked}", flush=True)

    detail = []
    device = {}
    for key, fused, inflight in (("fused", True, None),
                                 ("unfused", False, None),
                                 ("fused_inflight_0", True, 0)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _wait = _run(CS.encode_tiled, img, fused, inflight)
        ka = prof.key_averages()
        # the device's own events (kernels, copies); the CPU ops that
        # launched them report the same time again
        busy_ms = sum(e.self_device_time_total for e in ka
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      ) / 1e3
        device[key] = {"profiled_wall_ms": wall * 1e3, "busy_ms": busy_ms,
                       "idle_share": 1 - busy_ms / (wall * 1e3)}
        print(f"{key}: profiled wall {wall * 1e3:.1f} ms, device busy "
              f"{busy_ms:.2f} ms, idle share {device[key]['idle_share']:.4f}",
              flush=True)
        detail.append(f"== {key}\n" + ka.table(
            sort_by="self_device_time_total", row_limit=15))

    from hydrium_tpu_torch import encoder as torch_encoder
    from hydrium_tpu_torch import host as payload_host
    from hydrium_tpu_torch.jxl.tokcode import TokenCodec

    host = {}
    D = torch_encoder._TorchDispatch
    undo = [_timed(H.Encoder, "_tb_drain_unit", host, "drain_unit"),
            _timed(H.Encoder, "_tb_chunk", host, "chunk_dispatch"),
            _timed(D, "_fetch", host, "fetch_threads"),
            _timed(D, "drain", host, "edge_drain"),
            _timed(TokenCodec, "tables", host, "codec_tables"),
            _timed(payload_host, "_parse_packed", host, "parse_packed")]
    st = H.EncodeStats()
    t0 = time.perf_counter()
    CS.encode_tiled(img, True, st)
    wall = time.perf_counter() - t0
    for u in undo:
        u()
    print(f"fused, timed: wall {wall:.3f} s, host seconds {host}, stages "
          f"{dict(st.stage_seconds)}", flush=True)
    if args.detail:
        with open(args.detail, "w") as f:
            f.write("\n".join(detail))

    scratch.cleanup()
    print(json.dumps({
        "card": smi, "warm_wall_s": walls, "blocked_s": blocked,
        "warm_median_s": {k: statistics.median(v) for k, v in walls.items()},
        "blocked_median_s": {k: statistics.median(v)
                             for k, v in blocked.items()},
        "device": device, "timed_wall_s": wall, "host_s": host,
        "stages_s": dict(st.stage_seconds), "counters": dict(st.counters)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
