"""The benchmark of hydrium_tpu_torch (the PyTorch and CUDA port), one
cell a run:

    python3 -m jxlbench.run --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

from the root of a checkout.  The cell is looked up by name in
BENCHMARK.json; its configuration (jxlbench/configs/<config>.json), its
traffic (jxlbench/traffic/<traffic>.json), the content generator the
traffic names (jxlbench/content/<name>.py) and each per-layer metric
(jxlbench/metrics/<metric>.py) are found by name, so a new cell, mix or
metric is new files and entries only.

Set-up makes the traffic's pool of images on the card from the seed,
points the port's warm codec state at a new file under TMPDIR (so every
run starts from the same cold codec), and encodes the warm-up images, so
that every graph key replays.  The window then encodes the pool in turn
for --seconds (the last image runs to its end).  With --trace 0 the line
holds the cell's end-to-end metrics; with --trace 1 the window runs
under torch.profiler and the line holds its per-layer metrics, the
device's busy time and a breakdown.  After the window, every distinct
file is parsed whole by the plain reference (jxlbench/ref) and held to
the exact quantizer inputs of its image (jxlbench/check.py); each number
compared is printed with its limit, last on stderr and last in the line.

Exit codes: 0 with a result line; 2 no card (or fewer than the cell
asks for); 3 jax, jaxlib, flax or hydrium_tpu was loaded; other codes
from a failure, with no result line."""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hydrium_tpu")
PROGRAM_SWITCHES = ("HYDRIUM_INFLIGHT", "HYDRIUM_PALLAS", "HYDRIUM_TB_STACK_PX",
                    "HYDRIUM_HIST_SAMPLE_STRIDE", "HYDRIUM_STREAMING_THRESHOLD")


@dataclass
class Reading:
    """What a per-layer reader sees (jxlbench/metrics)."""
    window: object
    trace: object
    image_bytes: dict
    peaks: Optional[dict]


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"jxlbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(spec: dict, name: str):
    """(cell, its configuration file, its traffic file), each parsed."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"jxlbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(ROOT / entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Setup:
    """A run's set-up, as the window and the calibration take it over."""
    config: dict
    traffic: dict
    images: object
    loop: object
    seconds: float


def setup(spec: dict, name: str, seed: int, warm_dir: str,
          device: str = "cuda", size=None, t0: float = _T0) -> Setup:
    """The cell's images made from the seed, a cold codec (its warm state
    a new file under warm_dir) and the warm-up encodes; seconds: from t0
    to the end of the warm-up.  size (tests only): (height, width) in
    place of the traffic's."""
    from hydrium_tpu_torch import encoder

    encoder.reset_warm_state(os.path.join(warm_dir, "warm.npz"))

    from jxlbench.loop import Loop

    config, traffic = resolve(spec, name)[1:]
    params = dict(traffic["params"])
    if size is not None:
        params["height"], params["width"] = size
    content = load_module(BENCH / "content" / f"{traffic['content']}.py")
    t_make = time.perf_counter()
    images = content.make(params, seed, traffic["pool"], device)
    loop = Loop(config, device)
    t_warm = time.perf_counter()
    loop.warm(images, traffic["warmup_images"])
    loop.assert_precision()
    setup_s = time.perf_counter() - t0
    print(f"jxlbench: set-up {setup_s:.3f} s: start to images "
          f"{t_make - t0:.3f}, images {t_warm - t_make:.3f}, warm-up "
          f"{t0 + setup_s - t_warm:.3f}", file=sys.stderr)
    return Setup(config, traffic, images, loop, setup_s)


def drive(spec: dict, name: str, seed: int, seconds: float, trace: bool,
          warm_dir: str, device: str = "cuda", size=None, t0: float = _T0,
          workers: int = 4) -> Optional[dict]:
    """Everything of a run after the look for a card: returns the result
    line as a dict, or None when a forbidden module was loaded.  warm_dir:
    a new directory for the port's warm codec state.  size (tests only):
    (height, width) in place of the traffic's."""
    import numpy as np
    import torch

    from jxlbench import check, kernels
    from jxlbench import trace as tracing

    s = setup(spec, name, seed, warm_dir, device, size, t0)
    config, traffic, images, loop = s.config, s.traffic, s.images, s.loop
    setup_s = s.seconds
    del s
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    prof = None
    marker = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        marker = lambda: record_function(tracing.MARKER)  # noqa: E731
    try:
        win = loop.window(images, seconds, timeline=trace, marker=marker,
                          clients=traffic["clients"])
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_reserved(dev) if on_card else 0
    name_dev = torch.cuda.get_device_name(dev) if on_card else "cpu"
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": name_dev,
                   "count": 1, "memory_peak_bytes": int(peak)}

    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}
    metrics = {}
    breakdown = None
    if not trace:
        wanted = [m["name"] for m in spec["end_to_end"]
                  if name in m.get("workloads", [name])]
        values = {"mpix_s": win.pixels / win.seconds / 1e6,
                  "file_bpp": 8.0 * sum(i.nbytes for i in win.images)
                  / win.pixels,
                  "setup_s": setup_s}
        if on_card:
            values["device_mem_peak_mib"] = peak / 2 ** 20
        for m in wanted:
            if m in values:
                metrics[m] = {"value": values[m], "unit": units[m]}
    else:
        tr = (tracing.read(prof.events(), win.host_events, win.start,
                           win.seconds) if on_card else None)
        peaks = load_json(BENCH / "peaks.json")["devices"].get(name_dev)
        h, w = images.shape[1:3]
        reading = Reading(win, tr, kernels.image_bytes(h, w,
                                                       config["tile_size"]),
                          peaks)
        reported = {m["name"] for m in spec["end_to_end"]
                    if name in m.get("workloads", [name])}
        for m in spec["per_layer"]:
            if name not in m.get("workloads", [name]) or \
                    m["moves"] not in reported:
                continue
            v = load_module(BENCH / "metrics" / f"{m['name']}.py").read(
                reading)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tr is not None:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.top_ops(),
                         "idle_gaps": [[lab, s] for s, lab in tr.gaps]}
        prof = None

    # the program's state goes before the reference runs
    del loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        print(f"jxlbench: loaded in the run's process: {', '.join(found)}",
              file=sys.stderr)
        return None

    tc = time.perf_counter()
    verdict = check.judge_window(np.asarray(images), win.files, win.uses,
                                 config, workers)
    walls = sorted(i.wall_s for i in win.images)
    print(f"jxlbench: window {win.seconds:.3f} s, set-up {setup_s:.3f} s, "
          f"reference check {time.perf_counter() - tc:.3f} s; image walls "
          f"ms: first {win.images[0].wall_s * 1e3:.1f}, median "
          f"{walls[len(walls) // 2] * 1e3:.1f}, last "
          f"{win.images[-1].wall_s * 1e3:.1f}", file=sys.stderr)
    checks = verdict["checks"]
    correct = verdict["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    for f in verdict["faults"]:
        print(f"jxlbench: {f}", file=sys.stderr)
    print(f"jxlbench: {name} seed {seed}: {len(win.images)} images, "
          f"{verdict['files']} distinct files judged, flip share "
          f"{verdict['flip_share']}", file=sys.stderr)
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line = {"correct": correct, "attempted": len(win.images),
            "failed": verdict["failed"], "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    cell = resolve(spec, args.workload)[0]

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"jxlbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the configuration states every setting: the port's own switches
    # run at their defaults
    for var in PROGRAM_SWITCHES:
        os.environ.pop(var, None)
    # the port's warm codec state: a new file for this run under TMPDIR
    run_dir = tempfile.mkdtemp(prefix="jxlbench-")
    os.environ["HYDRIUM_TORCH_WARM_CACHE"] = os.path.join(run_dir, "warm.npz")
    try:
        line = drive(spec, args.workload, args.seed, args.seconds,
                     bool(args.trace), run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    if line is None:
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
