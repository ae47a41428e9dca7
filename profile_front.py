#!/usr/bin/env python3
"""Device time of the port's whole front stage on one CUDA card.

    python3 profile_front.py [--root DIR] [--reps 20] [--sass]
    python3 profile_front.py [--root DIR] --variant DIR OLD NEW

Runs ops/front.py::front_tokens, pixels of one LF-group buffer -> the
integer streams the transport stage reads, with the fused front
(fused=True) and the unfused one, on a u8 image made from a seed at the
shapes the encode paths give it: one 2048^2 LF group (G = 64), one
tiled chunk (a 4096x256 stack of 16 tiles, G = 16), the bottom LF group
of a 3840x2160 frame (true 112x2048 in a 128x2048 upload of a 256x2048
buffer, G = 8) and an edge tile (true 112x256 in a 128x256 upload, G =
1), `reps` times each.  Each call runs, with a synchronize,
inside a torch.profiler range; every device event (kernels, memsets,
copies) that starts inside the range is the call's.  Prints per shape
and front the median device time per call, the device events per call,
each event name's median device time per call, and the median time of
one call between CUDA events (host work included).  --root imports
hydrium_tpu_torch from another checkout (say, an unpacked parent
commit), so two versions of the stage can be timed in one call.  --sass
also counts the float32 instructions of the frontend kernel's u8
instantiations in the built library (cuobjdump -sass): an FFMA counts
as two operations, and the count over the 8 pixels a thread takes per
strip gives the operations per pixel that bound the kernel's arithmetic.
The last line is one JSON object of these numbers.

--variant copies --root's hydrium_tpu_torch into DIR with the text OLD
of csrc/frontend.cu replaced by NEW (it must occur once), and exits: an
ablation of the frontend kernel that a later run times with --root DIR
(it builds its own library under DIR/build).
"""

import argparse
import collections
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

# float32 instructions of the SASS and the operations each counts for
_F32_OPS = {"FFMA": 2, "FMUL": 1, "FADD": 1, "FMNMX": 1, "FSETP": 1,
            "FSEL": 1, "MUFU": 1, "F2I": 1, "I2F": 1, "FCHK": 1}


def sass_ops(lib_path: str) -> dict:
    """Per frontend kernel instantiation of the library: its static
    instruction count and float32 operations, and float32 operations
    per pixel (a thread takes 8 pixels per strip)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    txt = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, check=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", txt)[1:]:
        name = body.split("\n", 1)[0].strip()
        if "frontend_kernel" not in name:
            continue
        ops = collections.Counter()
        n = 0
        for line in body.split("\n"):
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                          line)
            if m:
                n += 1
                ops[m.group(1)] += 1
        f32 = sum(ops[k] * w for k, w in _F32_OPS.items())
        out[name] = {"instructions": n, "f32_ops": f32,
                     "f32_ops_per_pixel": f32 / 8,
                     "f32_by_opcode": {k: ops[k] for k in _F32_OPS if ops[k]}}
    return out


def make_variant(root: str, dst: str, old: str, new: str) -> None:
    """Copy root's hydrium_tpu_torch to dst, with `old` in
    csrc/frontend.cu (exactly one occurrence) replaced by `new`."""
    out = os.path.join(dst, "hydrium_tpu_torch")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(root, "hydrium_tpu_torch"), out,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(out, "csrc", "frontend.cu")
    with open(cu) as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f"profile_front: {old!r} occurs {text.count(old)} "
                         "times in frontend.cu, want once")
    with open(cu, "w") as f:
        f.write(text.replace(old, new))


# (name, true extent, upload, buffer) of the encode paths' front calls
SHAPES = (("lfg", (2048, 2048), (2048, 2048), (2048, 2048)),
          ("chunk", (4096, 256), (4096, 256), (4096, 256)),
          ("lfg_bottom", (112, 2048), (128, 2048), (256, 2048)),
          ("edge", (112, 256), (128, 256), (256, 256)))


def _profile(run, reps: int) -> dict:
    """Device events of `reps` calls of run, each in its own range."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            with record_function(f"front_call_{i}"):
                run()
                torch.cuda.synchronize()
    events = prof.events()
    calls = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name.startswith("front_call_")
                   and e.device_type == torch.autograd.DeviceType.CPU)
    assert len(calls) == reps, len(calls)
    per_call = [[] for _ in calls]
    for e in events:
        # the ranges themselves also appear as device-side spans
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name.startswith("front_call_")):
            continue
        for k, (t0, t1) in enumerate(calls):
            if t0 <= e.time_range.start <= t1:
                per_call[k].append(e)
    names = collections.Counter(e.name[:60] for c in per_call for e in c)
    device_ms = [sum(e.time_range.elapsed_us() for e in c) / 1e3
                 for c in per_call]
    by_name = {n: statistics.median(
        sum(e.time_range.elapsed_us() for e in c if e.name[:60] == n)
        for c in per_call) / 1e3 for n in names}
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"device_ms": statistics.median(device_ms),
            "device_events_per_call": sum(map(len, per_call)) / len(calls),
            "events": {k: v / len(calls) for k, v in names.items()},
            "event_ms": by_name, "call_ms": statistics.median(times)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--variant", nargs=3, metavar=("DIR", "OLD", "NEW"))
    args = ap.parse_args()
    if args.variant:
        make_variant(args.root, *args.variant)
        return 0

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_front: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from hydrium_tpu_torch.ops import _kernels
    from hydrium_tpu_torch.ops.front import FrontEnd, front_tokens

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    _kernels.lib()
    dev = torch.device("cuda")
    result = {"card": smi, "root": os.path.abspath(args.root)}
    if args.sass:
        result["sass"] = sass_ops(str(_kernels.library_path()))
        for name, rec in result["sass"].items():
            print(f"{name}: {rec['instructions']} instructions, float32 "
                  f"{rec['f32_by_opcode']} -> {rec['f32_ops']} operations, "
                  f"{rec['f32_ops_per_pixel']:.1f} per pixel", flush=True)
    front = FrontEnd.from_tables().to(dev)
    rng = np.random.default_rng(2048)
    for shape, (h, w), upload, (bh, bw) in SHAPES:
        host = np.zeros(upload + (3,), np.uint8)
        host[:h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        px = torch.as_tensor(host, device=dev)
        G = (bh >> 8) * (bw >> 8)
        presets = torch.zeros(G, dtype=torch.int32, device=dev)
        for fused in (True, False):
            run = lambda: front_tokens(
                front, px, h, w, presets, buf_h=bh, buf_w=bw,
                linear_light=False, sample_kind="uint8",
                clusters_per_preset=9, fused=fused)
            rec = _profile(run, args.reps)
            key = f"{shape}_{'fused' if fused else 'unfused'}"
            result[key] = dict(rec, h=h, w=w, G=G)
            print(f"{key} {h}x{w} (G={G}): front device "
                  f"{rec['device_ms']:.4f} ms in "
                  f"{rec['device_events_per_call']:.1f} device events per "
                  f"call, one call host included {rec['call_ms']:.4f} ms; "
                  f"events {rec['event_ms']}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
