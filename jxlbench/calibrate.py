"""The readings the limits of jxlbench/configs/*.json are set from
(run on a card; the benchmark's own runs never run this):

    python3 -m jxlbench.calibrate --workload <cell> --seeds a,b,... \
        [--control] [--out FILE]

For each seed, the run's own set-up (jxlbench.run.setup: the traffic's
pool made on the card, a cold codec, the warm-up encodes), then each
pool image encoded once and its file judged by check.judge_file.  That seed's program reading is the largest margin
over its files (the lower reading of a limit is the largest over the
seeds).  With --control, the TF32 control (ref/control.py) is judged on
the same images; its reading is the largest margin over them (the upper
reading is the smallest over the seeds).  One JSON object a seed goes to
stdout, and all of them to --out."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context


def judge_control(img, q_lf, q_hf) -> dict:
    from jxlbench.ref.compare import judge
    from jxlbench.ref.front import reference_inputs

    u_lf, u_hf = reference_inputs(img)
    return judge(u_lf, u_hf, q_lf, q_hf)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args(argv)

    import torch

    from jxlbench import run
    from jxlbench.check import judge_file

    if not torch.cuda.is_available():
        print("jxlbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    warm = tempfile.mkdtemp(prefix="jxlbench-cal-")
    from jxlbench.ref.control import control_q

    seeds = [int(s) for s in args.seeds.split(",")]
    jobs = []
    try:
        with ProcessPoolExecutor(max_workers=args.workers,
                                 mp_context=get_context("spawn")) as ex:
            for seed in seeds:
                # each seed starts as a run does, by the run's own set-up
                warm_dir = os.path.join(warm, str(seed))
                os.makedirs(warm_dir)
                s = run.setup(spec, args.workload, seed, warm_dir,
                              t0=time.perf_counter())
                for k, img in enumerate(s.images):
                    data = s.loop.encode(img)[0]
                    jobs.append((seed, "program", k,
                                 ex.submit(judge_file, img, data)))
                    if args.control:
                        q_lf, q_hf = control_q(img, "cuda")
                        jobs.append((seed, "control", k, ex.submit(
                            judge_control, img, q_lf, q_hf)))
                del s
            rows = {}
            for seed, side, k, fut in jobs:
                r = fut.result()
                row = rows.setdefault((seed, side), {
                    "seed": seed, "side": side, "margin_max": 0.0,
                    "flips": 0, "coefficients": 0, "parse_faults": []})
                if "parse_fault" in r:
                    row["parse_faults"].append(r["parse_fault"])
                    continue
                row["margin_max"] = max(row["margin_max"], r["margin_max"])
                row["flips"] += r["flips"]
                row["coefficients"] += r["coefficients"]
    finally:
        shutil.rmtree(warm, ignore_errors=True)
    out = [dict(r, workload=args.workload) for r in rows.values()]
    for r in out:
        print(json.dumps(r), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
