#!/usr/bin/env python3
"""Time the packed walk (csrc/host/serializer.cc hyd_hf_add_lfg_packed,
through jxl/native.py NativeHF.add_lfg_packed) of one photo4k image's
four LF-group payloads, and the ANS of its symbols (NativeHF.prepare,
encode_all and the sections' export), at 1, 2, 4 and 8 threads, on the
card's host.

    python3 profile_walk.py [--root DIR] [--seed N] [--reps R]
        [--device cuda|cpu] [--crop HxW] [--out PATH]

First a child of this checkout makes the image as the benchmark's
traffic photo4k does (jxlbench/content/photo.py from --seed), encodes
two images one-frame with a cold codec as the cell's warm-up does, and
keeps the payloads that the third encode's drain worker walks (each
LF group's parsed streams, code tables, cluster map, preset, grid and
extent).  Then each side replays them in a child process of its own,
from its own checkout: this one and, with --root, the one unpacked at
DIR (`git archive` of another commit), in the order root, this, this,
root.  A replay walks the image R times at each thread count, the
counts in turns, each time into fresh NativeHFs (one per preset, as
the encoder keeps them), then prepares them, ANS-encodes every section
on as many threads and exports the sections and frequencies, each
stage timed: the las, every cluster's frequencies and the sections'
bytes must be the same at every thread count and on both sides.
Prints the card's name and power limit, one JSON line a side (ms per
image of each stage, each time), and a summary line: per side, stage
and thread count the median and quartile distance of ms per image,
and ns per symbol at the median.  --device cpu --crop 256x512
rehearses the script on a machine without a card.

    python3 profile_walk.py --capture PATH --seed N --device D --crop HxW
    python3 profile_walk.py --replay PATH --reps R

are the capture and one side (run from its checkout's root).
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
THREADS = (1, 2, 4, 8)
STAGES = ("walk", "prepare", "encode_all", "export")


def capture(path: str, seed: int, device: str, crop) -> int:
    sys.path.insert(0, os.getcwd())
    from hydrium_tpu_torch import encoder as E
    from hydrium_tpu_torch import host
    from jxlbench import loop, run

    tmp = tempfile.TemporaryDirectory(prefix="hyd_walk_")
    E.reset_warm_state(os.path.join(tmp.name, "warm.npz"))
    config = run.load_json(run.BENCH / "configs" / "u8_oneframe.json")
    traffic = run.load_json(run.BENCH / "traffic" / "photo4k.json")
    params = dict(traffic["params"])
    if crop:
        params["height"], params["width"] = crop
    content = run.load_module(run.BENCH / "content" / "photo.py")
    images = content.make(params, seed, 3, device)
    lp = loop.Loop(config, device)
    lp.warm(images, 2)
    got = []
    feed = host._feed_hf_packed

    def keep(hf, parsed, lfg, buf_w, buf_h, preset, tok_lut):
        got.append({
            "tok_words": parsed["tok_words"].copy(),
            "res_words": parsed["res_words"].copy(),
            "tok_off": parsed["tok_off"], "res_off": parsed["res_off"],
            "gs": parsed["gs"], "tok_lut": tok_lut.copy(),
            "cluster_map": hf.cluster_map, "preset": preset,
            "grid": (buf_h >> 8, buf_w >> 8),
            "extent": (lfg.varblock_height, lfg.varblock_width),
            "las": getattr(hf, "FIXED_LAS", 0)})
        return feed(hf, parsed, lfg, buf_w, buf_h, preset, tok_lut)

    host._feed_hf_packed = keep
    try:
        lp.encode(images[2])
    finally:
        host._feed_hf_packed = feed
    tmp.cleanup()
    import numpy as np

    arrays = {}
    for i, p in enumerate(got):
        for k, v in p.items():
            arrays[f"{i}.{k}"] = np.asarray(v)
    np.savez(path, n=len(got), **arrays)
    print(json.dumps({"payloads": len(got),
                      "symbols": int(sum(p["gs"].sum() for p in got))}),
          flush=True)
    return 0


def _load(path: str) -> list:
    import numpy as np

    z = np.load(path)
    out = []
    for i in range(int(z["n"])):
        p = {k.split(".", 1)[1]: z[k] for k in z.files
             if k.startswith(f"{i}.")}
        for k in ("preset", "las"):
            p[k] = int(p[k])
        p["grid"] = tuple(int(v) for v in p["grid"])
        p["extent"] = tuple(int(v) for v in p["extent"])
        out.append(p)
    return out


def _walk(native, payloads, n_threads: int):
    """One image's walk into fresh NativeHFs, one per preset: (seconds
    in add_lfg_packed, {preset: NativeHF})."""
    hfs, secs = {}, 0.0
    for p in payloads:
        hf = hfs.get(p["preset"])
        if hf is None:
            hf = hfs[p["preset"]] = native.NativeHF(
                int(p["cluster_map"].max()) + 1)
            if p["las"]:
                hf.force_las(p["las"])
        t0 = time.perf_counter()
        hf.add_lfg_packed(p["tok_words"], p["res_words"], p["tok_lut"],
                          p["cluster_map"], p["preset"], p["grid"],
                          p["extent"], p["tok_off"], p["res_off"], p["gs"],
                          n_threads=n_threads)
        secs += time.perf_counter() - t0
    return secs, hfs


def _ans(hfs, n_clusters: int, n_threads: int):
    """Prepare, encode_all on n_threads and export of every preset's
    NativeHF: ({stage: seconds}, sha256 of the las, every cluster's
    frequencies and every section)."""
    secs = dict.fromkeys(STAGES[1:], 0.0)
    results = []
    for preset in sorted(hfs):
        hf = hfs[preset]
        t0 = time.perf_counter()
        hf.prepare()
        t1 = time.perf_counter()
        writers = hf.encode_all(3, n_threads=n_threads)
        t2 = time.perf_counter()
        results.append((hf.las,
                        [hf.frequencies(c) for c in range(n_clusters)],
                        [w.export_raw() for w in writers]))
        t3 = time.perf_counter()
        secs["prepare"] += t1 - t0
        secs["encode_all"] += t2 - t1
        secs["export"] += t3 - t2
    h = hashlib.sha256()
    for las, freqs, sections in results:
        h.update(str(las).encode())
        for f in freqs:
            h.update(f.tobytes())
        for data, tail, bits in sections:
            h.update(data + str((tail, bits)).encode())
    return secs, h.hexdigest()


def replay(path: str, reps: int) -> int:
    sys.path.insert(0, os.getcwd())
    from hydrium_tpu_torch.jxl import native

    assert native.__file__.startswith(os.getcwd()), native.__file__
    payloads = _load(path)
    symbols = int(sum(p["gs"].sum() for p in payloads))
    n_clusters = int(payloads[0]["cluster_map"].max()) + 1
    times = {st: {n: [] for n in THREADS} for st in STAGES}
    digests = set()
    _walk(native, payloads, 1)      # builds and loads the library
    for _ in range(reps):
        for n in THREADS:
            walk, hfs = _walk(native, payloads, n)
            ans, digest = _ans(hfs, n_clusters, n)
            digests.add(digest)
            times["walk"][n].append(walk)
            for st, sec in ans.items():
                times[st][n].append(sec)
    if len(digests) != 1:
        raise RuntimeError(f"thread counts gave other results: {digests}")
    print(json.dumps({
        "root": os.getcwd(), "symbols": symbols, "digest": digests.pop(),
        "ms_per_image": {st: {n: [1e3 * s for s in w]
                              for n, w in by_n.items()}
                         for st, by_n in times.items()}}), flush=True)
    return 0


def _run_child(argv, cwd) -> dict:
    res = subprocess.run([sys.executable, os.path.join(HERE, __file__),
                          *argv], cwd=cwd, capture_output=True, text=True,
                         timeout=1200)
    if res.returncode != 0:
        raise RuntimeError(f"child {argv} in {cwd} failed:\n"
                           f"{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def _quartiles(xs) -> dict:
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return {"median": q2, "iqr": q3 - q1, "n": len(xs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--seed", type=int, default=2147483647)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--crop", default=None, metavar="HxW")
    ap.add_argument("--out", default=None)
    ap.add_argument("--capture", default=None, metavar="PATH")
    ap.add_argument("--replay", default=None, metavar="PATH")
    args = ap.parse_args()
    crop = tuple(int(v) for v in args.crop.split("x")) if args.crop else None
    if args.capture:
        return capture(args.capture, args.seed, args.device, crop)
    if args.replay:
        return replay(args.replay, args.reps)
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60,
                              check=True).stdout.strip()
    else:
        card = "cpu"
    print(card, flush=True)
    sides = [("this", HERE)]
    if args.root:
        root = os.path.abspath(args.root)
        sides = [("root", root), ("this", HERE), ("this", HERE),
                 ("root", root)]
    with tempfile.TemporaryDirectory(prefix="hyd_walk_") as td:
        path = os.path.join(td, "payloads.npz")
        cap = _run_child(["--capture", path, "--seed", str(args.seed),
                          "--device", args.device]
                         + (["--crop", args.crop] if args.crop else []),
                         HERE)
        print(json.dumps({"capture": cap}), flush=True)
        runs = []
        for label, cwd in sides:
            line = _run_child(["--replay", path, "--reps", str(args.reps)],
                              cwd)
            print(json.dumps({"side": label, **line}), flush=True)
            runs.append((label, line))
    if len({line["digest"] for _, line in runs}) != 1:
        print("the sides' walks gave other results", file=sys.stderr)
        return 1
    summary = {"card": card, "order": [label for label, _ in sides],
               "symbols": runs[0][1]["symbols"]}
    for label in dict.fromkeys(label for label, _ in sides):
        for st in STAGES:
            for n in map(str, THREADS):
                ms = [v for lab, line in runs if lab == label
                      for v in line["ms_per_image"][st][n]]
                q = _quartiles(ms)
                q["ns_per_sym"] = 1e6 * q["median"] / runs[0][1]["symbols"]
                summary[f"{label}_{st}_t{n}"] = q
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"capture": cap, "runs": runs, "summary": summary}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
