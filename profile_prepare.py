#!/usr/bin/env python3
"""Pair two versions of the port on the card over the rows that the
dispatch-preparation pool touches: the bench's smooth and noisy
(`value`) 3840x2160 one-frame encodes through Encoder.send_tile, the
command line (hydrium_tpu_torch.cli.main, in process) on the noisy
image written as a PNG, and the noisy image tiled (256^2 tiles, one
send_tile_batch call a row) with the fused front (`tiled_fused`).

    python3 profile_prepare.py [--root DIR] [--iters N] [--cold-reps R]
        [--out PATH]

Each side runs in a child process of its own, from its own checkout:
this one, and with --root the one unpacked at DIR (`git archive` of
another commit), in the order root, this, this, root.  A child encodes
each image once to warm the transport codec (its own temporary warm
state), then `iters` timed encodes a row: the wall (first tile to last
output, device synchronized), the wall of each send_tile call, the
stages dispatch (the calling thread), prepare (the prep workers; absent
in a version without the pool) and fetch_wait, and, for the rows an
Encoder of the script's own runs (not the CLI), the duration of every
dispatch[y,x] timeline event on a "hyd-prep" thread: the upload
excluded, the enqueue of one dispatch (or, with ops/graphs.py, its
graph's replay) with the code tables.  Every encode of a row must give
the same bytes, and both sides the same sha256.  A child also reports
its graphs (ops/graphs.py::graph_stats) where its version has them.
Then the first encode of a fresh process, as each call of the command
line is: per side (the same order, R times over) a seed child encodes the noisy image once
through the CLI, which leaves the transport codec's warm state in a
temporary file of that side's, as a user's earlier calls leave it; then
for each of the rows `cli` and `tiled_fused` a child of its own with
that warm state, the device up and the kernel library loaded, times
two encodes of the row (walls as above): the first, with no graph made
yet, and the second, which reuses what the first left (with
ops/graphs.py: each key's first dispatch eager, its second captured).
Prints the card's name and power limit, one JSON line a child, then one
summary line: per row and side, the median and the quartile distance
of all its walls, and the same for the send_tile calls and the
dispatch events; and per cold row and side the first and second walls
of each child.

    python3 profile_prepare.py --child ITERS
    python3 profile_prepare.py --cold-child seed|cli|tiled_fused

are one side and one cold child (run from its checkout's root).
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _row(encode, iters: int) -> dict:
    walls, sends, stages, events, digest = [], [], [], [], None
    for _ in range(iters):
        wall, calls, st, data = encode()
        d = hashlib.sha256(data).hexdigest()
        if digest not in (None, d):
            raise RuntimeError("an encode of the row gave other bytes")
        digest = d
        walls.append(wall)
        sends.extend(calls)
        stages.append({k: st.stage_seconds.get(k, 0.0)
                       for k in ("dispatch", "prepare", "fetch_wait")})
        events.extend(1e3 * (t1 - t0) for name, t0, t1, thread
                      in st.events or () if name.startswith("dispatch[")
                      and thread.startswith("hyd-prep"))
    return {"walls_s": walls, "send_calls_s": sends, "sha256": digest,
            "dispatch_event_ms": events,
            "stages_s": {k: statistics.median(s[k] for s in stages)
                         for k in stages[0]}}


def _rows(tmp: str) -> dict:
    """{row: encode()} of this checkout's port (module docstring); each
    encode() returns (wall, send_tile walls, stats, bytes)."""
    import torch

    import hydrium_tpu_torch as H
    from hydrium_tpu_torch import cli
    from hydrium_tpu_torch.bench import make_4k_noisy, make_4k_smooth
    from hydrium_tpu_torch.scale import made_encoders, write_png

    assert H.__file__.startswith(os.getcwd()), H.__file__

    def one_frame(img):
        h, w = img.shape[:2]
        enc = H.Encoder(H.ImageMetadata(width=w, height=h), device="cuda")
        enc.stats.enable_timeline()
        out, calls = bytearray(), []
        t0 = time.perf_counter()
        for ty in range(-(-h // 2048)):
            for tx in range(-(-w // 2048)):
                t1 = time.perf_counter()
                enc.send_tile(img[ty * 2048:(ty + 1) * 2048,
                                  tx * 2048:(tx + 1) * 2048], tx, ty)
                calls.append(time.perf_counter() - t1)
                out.extend(enc.take_output())
        torch.cuda.synchronize()
        return time.perf_counter() - t0, calls, enc.stats, bytes(out)

    def tiled_fused(img):
        h, w = img.shape[:2]
        enc = H.Encoder(H.ImageMetadata(width=w, height=h,
                                        tile_size_shift_x=0,
                                        tile_size_shift_y=0),
                        device="cuda", fused_front=True)
        enc.stats.enable_timeline()
        out, calls = bytearray(), []
        t0 = time.perf_counter()
        for ty in range(-(-h // 256)):
            t1 = time.perf_counter()
            enc.send_tile_batch([(img[ty * 256:(ty + 1) * 256,
                                      tx * 256:(tx + 1) * 256], tx, ty)
                                 for tx in range(-(-w // 256))])
            calls.append(time.perf_counter() - t1)
            out.extend(enc.take_output())
        torch.cuda.synchronize()
        return time.perf_counter() - t0, calls, enc.stats, bytes(out)

    png = os.path.join(tmp, "in.png")
    jxl = os.path.join(tmp, "out.jxl")
    noisy, smooth = make_4k_noisy(), make_4k_smooth()
    write_png(png, noisy)

    def run_cli():
        with made_encoders() as made:
            t0 = time.perf_counter()
            if cli.main([png, jxl, "--one-frame"]) != 0:
                raise RuntimeError("the CLI failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        with open(jxl, "rb") as f:
            return wall, [], made[0].stats, f.read()

    return {"smooth": lambda: one_frame(smooth),
            "value": lambda: one_frame(noisy), "cli": run_cli,
            "tiled_fused": lambda: tiled_fused(noisy)}


def _graph_stats():
    try:
        from hydrium_tpu_torch.ops.graphs import graph_stats
    except ImportError:             # a version without graphs
        return None
    return graph_stats()


def child(iters: int) -> int:
    sys.path.insert(0, os.getcwd())
    from hydrium_tpu_torch import encoder as E

    tmp = tempfile.TemporaryDirectory(prefix="hyd_prep_")
    E.reset_warm_state(os.path.join(tmp.name, "warm.npz"))
    rows = {}
    for name, encode in _rows(tmp.name).items():
        encode()                    # the codec adapts to this content
        rows[name] = _row(encode, iters)
    tmp.cleanup()
    print(json.dumps({"root": os.getcwd(), "rows": rows,
                      "graphs": _graph_stats()}), flush=True)
    return 0


def cold_child(row: str) -> int:
    """One fresh process (module docstring); its codec's warm state is
    the file $HYDRIUM_TORCH_WARM_CACHE names.  `seed` runs the CLI once
    and prints nothing."""
    sys.path.insert(0, os.getcwd())
    import torch

    from hydrium_tpu_torch.ops import _kernels

    tmp = tempfile.TemporaryDirectory(prefix="hyd_cold_")
    encoders = _rows(tmp.name)
    if row == "seed":
        encoders["cli"]()
        return 0
    torch.zeros(1, device="cuda")
    _kernels.lib()
    torch.cuda.synchronize()
    walls, digests = [], set()
    for _ in range(2):
        wall, _calls, _st, data = encoders[row]()
        walls.append(wall)
        digests.add(hashlib.sha256(data).hexdigest())
    if len(digests) != 1:
        raise RuntimeError("the two encodes gave other bytes")
    tmp.cleanup()
    print(json.dumps({"root": os.getcwd(), "row": row, "walls_s": walls,
                      "sha256": digests.pop(), "graphs": _graph_stats()}),
          flush=True)
    return 0


COLD_ROWS = ("cli", "tiled_fused")


def _run_child(argv, cwd, env=None) -> dict:
    """One child of this script from checkout `cwd`; its last line."""
    res = subprocess.run([sys.executable, os.path.join(HERE, __file__),
                          *argv], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=1200)
    if res.returncode != 0:
        raise RuntimeError(f"child {argv} in {cwd} failed:\n"
                           f"{res.stderr[-4000:]}")
    lines = res.stdout.strip().splitlines()
    return json.loads(lines[-1]) if lines else {}


def _quartiles(xs) -> dict:
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return {"median": q2, "iqr": q3 - q1, "n": len(xs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cold-reps", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", type=int, default=None, metavar="ITERS")
    ap.add_argument("--cold-child", default=None,
                    choices=("seed",) + COLD_ROWS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child)
    if args.cold_child is not None:
        return cold_child(args.cold_child)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    sides = [("this", HERE)]
    if args.root:
        root = os.path.abspath(args.root)
        sides = [("root", root), ("this", HERE), ("this", HERE),
                 ("root", root)]
    runs, cold = [], []
    for label, cwd in sides:
        line = _run_child(["--child", str(args.iters)], cwd)
        print(json.dumps({"side": label, **line}), flush=True)
        runs.append((label, line["rows"]))
    for label, cwd in sides * args.cold_reps:
        with tempfile.TemporaryDirectory(prefix="hyd_cold_") as td:
            env = dict(os.environ, HYDRIUM_TORCH_WARM_CACHE=os.path.join(
                td, "warm.npz"))
            _run_child(["--cold-child", "seed"], cwd, env)
            for row in COLD_ROWS:
                line = _run_child(["--cold-child", row], cwd, env)
                print(json.dumps({"side": label, **line}), flush=True)
                cold.append((label, line))
    summary = {"card": smi, "order": [label for label, _ in sides]}
    for row in runs[0][1]:
        digests = {rows[row]["sha256"] for _, rows in runs}
        if len(digests) != 1:
            print(f"{row}: the sides' files differ: {digests}",
                  file=sys.stderr)
            return 1
        for label in dict.fromkeys(label for label, _ in sides):
            mine = [rows[row] for lab, rows in runs if lab == label]
            walls = [w for r in mine for w in r["walls_s"]]
            sends = [c for r in mine for c in r["send_calls_s"]]
            events = [e for r in mine for e in r["dispatch_event_ms"]]
            summary[f"{row}_{label}"] = {
                "wall_s": _quartiles(walls),
                "send_call_s": _quartiles(sends) if sends else None,
                "dispatch_event_ms": _quartiles(events) if events else None,
                "stages_s_by_run": [r["stages_s"] for r in mine]}
    for row in COLD_ROWS:
        if len({line["sha256"] for _, line in cold
                if line["row"] == row}) != 1:
            print(f"cold {row}: the sides' files differ", file=sys.stderr)
            return 1
        for label in dict.fromkeys(label for label, _ in sides):
            summary[f"cold_{row}_{label}"] = {
                "first_s": [line["walls_s"][0] for lab, line in cold
                            if lab == label and line["row"] == row],
                "second_s": [line["walls_s"][1] for lab, line in cold
                             if lab == label and line["row"] == row]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "cold": cold, "summary": summary}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
