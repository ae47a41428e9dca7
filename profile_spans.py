#!/usr/bin/env python3
"""What the port's spans (hydrium_tpu_torch/utils/stats.py) cost, and
where the benchmark's clock puts them, on the card.

    python3 profile_spans.py [--root DIR] [--seconds S] [--seed N]
        [--out PATH]

1. stage() with the timeline off and on (no profiler): ns per call, the
   median of 15 rounds of 20,000 empty stages, untagged and, where the
   version has tags, tagged; each side in a child process of its own,
   from its own checkout (this one and, with --root, the one unpacked at
   DIR), in the order this, root, root, this.
2. The cell oneframe.photo4k as jxlbench sets it up (its images from
   --seed, a cold codec, the warm-up), then four windows of S seconds,
   untraced and traced in turns; a traced window runs as jxlbench.run
   traces one (torch.profiler over CPU and CUDA, the jxlbench.window
   marker, the encoders' timelines on).  Per window: mpix_s and the
   benchmark's stage and counter readers.
3. Per traced window: the offset between each span's start on the host
   clock and its mirrored profiler event moved by jxlbench/trace.py's
   shift (window start - marker start), median and largest, in us, over
   the spans the profiler recorded; per image, stage codec_tables less
   prepare; per LF group, drain_wait + parse + walk on hyd-drain less
   the pipeline+transfer span that holds them (the largest, in ms).

Prints the card's name and power limit and one JSON line; --out writes
the same object to a file.  Needs a card.

    python3 profile_spans.py --stage-child

is one side of part 1 (run from its checkout's root).
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "oneframe.photo4k"
READERS = ("prepare_ms", "fetch_wait_ms", "host_entropy_ms",
           "codec_tables_ms", "codec_rebuild_share", "payload_parse_ms",
           "drain_wait_ms")


def stage_child() -> dict:
    """Part 1 for the checkout this process runs from."""
    sys.path.insert(0, os.getcwd())
    from hydrium_tpu_torch.utils.stats import EncodeStats

    def per_call(stats, *args, n=20000, rounds=15):
        out = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(n):
                with stats.stage(*args):
                    pass
            out.append((time.perf_counter() - t0) / n * 1e9)
            if stats.events is not None:
                stats.events.clear()
        return statistics.median(out)

    res = {"off_ns": per_call(EncodeStats(), "walk")}
    on = EncodeStats()
    on.enable_timeline()
    res["on_ns"] = per_call(on, "walk")
    try:
        res["off_tagged_ns"] = per_call(EncodeStats(), "walk", (1, 0))
        res["on_tagged_ns"] = per_call(on, "walk", (1, 0))
    except TypeError:
        pass                        # a version without tags
    return res


def stage_costs(root) -> list:
    sides = [("this", HERE)] + ([("root", root)] if root else [])
    order = sides + sides[::-1]
    rows = []
    for name, cwd in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--stage-child"], cwd=cwd, check=True,
                             capture_output=True, text=True).stdout
        rows.append(dict(json.loads(out.strip().splitlines()[-1]),
                         side=name))
    return rows


def clock_offsets(prof_events, host_events, window_start, caller):
    """us between each recorded span's host start and its mirror's
    start moved by trace.py's shift; spans of a name are paired in
    order where the profiler holds as many as the caller's thread (a
    profiler of that thread alone) or as all threads."""
    import torch

    from jxlbench import trace as tracing

    cuda = torch.autograd.DeviceType.CUDA
    cpu = [e for e in prof_events if e.device_type != cuda]
    m0 = [e for e in cpu if e.name == tracing.MARKER][0].time_range.start
    shift = window_start - m0 / 1e6
    names = {e[0] for e in host_events}
    mirrors = {}
    for e in cpu:
        if e.name in names:
            mirrors.setdefault(e.name, []).append(e.time_range.start / 1e6)
    offsets, skipped = [], 0
    for name, starts in mirrors.items():
        evs = sorted(e for e in host_events if e[0] == name)
        mine = [e for e in evs if e[3] == caller]
        pair = mine if len(mine) == len(starts) else evs
        if len(pair) != len(starts):
            skipped += 1
            continue
        offsets += [1e6 * (s + shift - h[1])
                    for s, h in zip(sorted(starts), pair)]
    absolute = [abs(o) for o in offsets]
    return {"spans": len(offsets), "names_skipped": skipped,
            "median_us": statistics.median(offsets) if offsets else None,
            "largest_abs_us": max(absolute) if absolute else None}


def extents(win) -> dict:
    """The acceptance checks on one traced window's spans."""
    tables = [1e3 * (i.stages.get("codec_tables", 0.0)
                     - i.stages.get("prepare", 0.0)) for i in win.images]
    inner = ("drain_wait", "parse", "walk")
    drain = [e for e in win.host_events if e[3].startswith("hyd-drain")]
    excess = []
    for name, t0, t1, thread in drain:
        if not name.startswith("pipeline+transfer["):
            continue
        tag = name[name.index("["):]
        held = sum(b - a for n, a, b, th in drain
                   if th == thread and t0 <= a <= b <= t1
                   and n in [f"{k}{tag}" for k in inner])
        excess.append(1e3 * (held - (t1 - t0)))
    return {"codec_tables_less_prepare_ms_max": max(tables),
            "drain_inner_less_pipeline_ms_max": max(excess) if excess
            else None, "lf_groups": len(excess)}


def windows(seconds: float, seed: int, count: int = 4, device="cuda",
            size=None) -> dict:
    """Part 2 and 3; device and size (a rehearsal on the CPU): as
    jxlbench.run.setup takes them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from jxlbench import run
    from jxlbench import trace as tracing

    for var in run.PROGRAM_SWITCHES:
        os.environ.pop(var, None)
    warm = tempfile.mkdtemp(prefix="profile-spans-")
    os.environ["HYDRIUM_TORCH_WARM_CACHE"] = os.path.join(warm, "warm.npz")
    try:
        spec = run.load_json(run.ROOT / "BENCHMARK.json")
        s = run.setup(spec, CELL, seed, warm, device, size)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device == "cuda" else [])
        out = []
        for k in range(count):
            traced = k % 2 == 1
            prof = marker = None
            if traced:
                prof = profile(activities=acts)
                prof.__enter__()
                marker = lambda: record_function(tracing.MARKER)  # noqa
            try:
                win = s.loop.window(s.images, seconds, timeline=traced,
                                    marker=marker)
            finally:
                if prof is not None:
                    prof.__exit__(None, None, None)
            reading = run.Reading(win, None, {}, None)
            row = {"traced": traced, "images": len(win.images),
                   "window_s": win.seconds,
                   "mpix_s": win.pixels / win.seconds / 1e6}
            if traced:
                row.update({m: run.load_module(
                    run.BENCH / "metrics" / f"{m}.py").read(reading)
                    for m in READERS})
                row["clock"] = clock_offsets(prof.events(), win.host_events,
                                             win.start, "MainThread")
                row.update(extents(win))
            out.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
        return {"setup_s": s.seconds, "windows": out,
                "card": (torch.cuda.get_device_name(0) if device == "cuda"
                         else "cpu")}
    finally:
        shutil.rmtree(warm, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="another checkout to pair part 1 with")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2**31 + 99)
    ap.add_argument("--out")
    ap.add_argument("--stage-child", action="store_true")
    args = ap.parse_args()
    if args.stage_child:
        print(json.dumps(stage_child()))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profile_spans: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    res = {"smi": smi, "stage": stage_costs(args.root)}
    print(json.dumps(res["stage"]), flush=True)
    res.update(windows(args.seconds, args.seed))
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
