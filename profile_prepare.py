#!/usr/bin/env python3
"""Pair two versions of the port on the card over the rows that the
dispatch-preparation pool touches: the bench's smooth and noisy
(`value`) 3840x2160 one-frame encodes through Encoder.send_tile, and
the command line (hydrium_tpu_torch.cli.main, in process) on the noisy
image written as a PNG.

    python3 profile_prepare.py [--root DIR] [--iters N] [--out PATH]

Each side runs in a child process of its own, from its own checkout:
this one, and with --root the one unpacked at DIR (`git archive` of
another commit), in the order root, this, this, root.  A child encodes
each image once to warm the transport codec (its own temporary warm
state), then `iters` timed encodes a row: the wall (first tile to last
output, device synchronized), the wall of each send_tile call, the
stages dispatch (the calling thread), prepare (the prep workers; absent
in a version without the pool) and fetch_wait.  Every encode of a row
must give the same bytes, and both sides the same sha256.  Prints the
card's name and power limit, one JSON line a child, then one summary
line: per row and side, the median and the quartile distance of all its
walls, and the same for the send_tile calls.

    python3 profile_prepare.py --child ITERS

is one side (run from its checkout's root).
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
    walls, sends, stages, digest = [], [], [], None
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
    return {"walls_s": walls, "send_calls_s": sends, "sha256": digest,
            "stages_s": {k: statistics.median(s[k] for s in stages)
                         for k in stages[0]}}


def child(iters: int) -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import hydrium_tpu_torch as H
    from hydrium_tpu_torch import cli
    from hydrium_tpu_torch import encoder as E
    from hydrium_tpu_torch.bench import make_4k_noisy, make_4k_smooth
    from hydrium_tpu_torch.scale import made_encoders, write_png

    assert H.__file__.startswith(os.getcwd()), H.__file__
    tmp = tempfile.TemporaryDirectory(prefix="hyd_prep_")
    E.reset_warm_state(os.path.join(tmp.name, "warm.npz"))

    def one_frame(img):
        h, w = img.shape[:2]
        enc = H.Encoder(H.ImageMetadata(width=w, height=h), device="cuda")
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

    png = os.path.join(tmp.name, "in.png")
    jxl = os.path.join(tmp.name, "out.jxl")
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

    rows = {}
    for name, encode in (("smooth", lambda: one_frame(smooth)),
                         ("value", lambda: one_frame(noisy)),
                         ("cli", run_cli)):
        encode()                    # the codec adapts to this content
        rows[name] = _row(encode, iters)
    tmp.cleanup()
    print(json.dumps({"root": os.getcwd(), "rows": rows}), flush=True)
    return 0


def _quartiles(xs) -> dict:
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return {"median": q2, "iqr": q3 - q1, "n": len(xs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", type=int, default=None, metavar="ITERS")
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    sides = [("this", HERE)]
    if args.root:
        root = os.path.abspath(args.root)
        sides = [("root", root), ("this", HERE), ("this", HERE),
                 ("root", root)]
    runs = []
    for label, cwd in sides:
        res = subprocess.run([sys.executable, os.path.join(HERE, __file__),
                              "--child", str(args.iters)], cwd=cwd,
                             capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": label, **line}), flush=True)
        runs.append((label, line["rows"]))
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
            summary[f"{row}_{label}"] = {
                "wall_s": _quartiles(walls),
                "send_call_s": _quartiles(sends) if sends else None,
                "stages_s_by_run": [r["stages_s"] for r in mine]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "summary": summary}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
