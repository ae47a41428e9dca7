#!/usr/bin/env python3
"""Device time of the port's whole transport stage on one CUDA card.

    python3 profile_transport.py [--root DIR] [--reps 20]

Runs ops/transport.py::hf_transport_streams, the stage that turns the
front's [N, 64] tensors into the transport streams, the sampled
histogram and tok_ok, on inputs made from a seed at the shape of one
2048^2 LF group (N = 196,608 rows) and of one tiled chunk (N = 49,152),
`reps` times each.  Each call runs, with a synchronize, inside a
torch.profiler range; every device event (kernels, memsets) that starts
inside the range is the call's.  Prints per shape the median device time
per call, the device events per call, their names with each name's
median device time per call, and the median time of one call between
CUDA events (host work included).  --root
imports hydrium_tpu_torch from another checkout (say, an unpacked parent
commit), so two versions of the stage can be timed in one call.  The
last line is one JSON object of these numbers.
"""

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys


def _inputs(rng, N, dev):
    """The front's outputs as the stage reads them, tokens below 64."""
    import numpy as np
    import torch

    tokens = rng.integers(0, 64, (N, 64)).astype(np.int16)
    clusters = rng.integers(0, 27, (N, 64)).astype(np.uint8)
    valid_len = rng.integers(0, 65, N).astype(np.int32)
    rbits = rng.integers(0, 31, (N, 64)).astype(np.uint8)
    res = (rng.integers(0, 1 << 31, (N, 64), dtype=np.int64)
           & ((1 << rbits.astype(np.int64)) - 1)).astype(np.int32)
    lens = rng.integers(1, 13, 10 * 64).astype(np.int32)
    codes = (rng.integers(0, 1 << 12, 10 * 64) & ((1 << lens) - 1)).astype(
        np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)
    out = {"tokens": t(tokens), "clusters": t(clusters),
           "valid_len": t(valid_len), "residues": t(res),
           "residue_bits": t(rbits)}
    return out, t(lens), t(codes)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_transport: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from torch.profiler import ProfilerActivity, profile, record_function

    from hydrium_tpu_torch.ops import _kernels
    from hydrium_tpu_torch.ops.transport import hf_transport_streams

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    _kernels.lib()
    dev = torch.device("cuda")
    rng = np.random.default_rng(2048)
    result = {"card": smi, "root": os.path.abspath(args.root)}
    for shape, N in (("lfg", 196608), ("chunk", 49152)):
        out, lens, codes = _inputs(rng, N, dev)
        run = lambda: hf_transport_streams(out, lens, codes, 9)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(args.reps):
                with record_function(f"stage_call_{i}"):
                    run()
                    torch.cuda.synchronize()
        events = prof.events()
        calls = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.name.startswith("stage_call_")
                       and e.device_type == torch.autograd.DeviceType.CPU)
        assert len(calls) == args.reps, len(calls)
        per_call = [[] for _ in calls]
        for e in events:
            # the ranges themselves also appear as device-side spans
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.name.startswith("stage_call_")):
                continue
            for k, (t0, t1) in enumerate(calls):
                if t0 <= e.time_range.start <= t1:
                    per_call[k].append(e)
        names = collections.Counter(e.name[:60] for c in per_call for e in c)
        device_ms = [sum(e.time_range.elapsed_us() for e in c) / 1e3
                     for c in per_call]
        # per event name: its median device time per call
        by_name = {n: statistics.median(
            sum(e.time_range.elapsed_us() for e in c if e.name[:60] == n)
            for c in per_call) / 1e3 for n in names}
        times = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        rec = {"N": N, "device_ms": statistics.median(device_ms),
               "device_events_per_call": sum(map(len, per_call)) / len(calls),
               "events": {k: v / len(calls) for k, v in names.items()},
               "event_ms": by_name,
               "call_ms": statistics.median(times)}
        result[shape] = rec
        print(f"{shape} N={N}: stage device {rec['device_ms']:.4f} ms in "
              f"{rec['device_events_per_call']:.1f} device events per call, "
              f"one call host included {rec['call_ms']:.4f} ms; events "
              f"{rec['events']}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
