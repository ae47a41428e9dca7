#!/usr/bin/env python3
"""Device memory of the scale configurations (hydrium_tpu_torch/scale.py,
BASELINE configs 4 and 5 at chip_smoke.py phase 11's sizes), paired
between two versions of the port on the card.

    python3 profile_memory.py [--root DIR] [--out PATH]

Each config runs in a child process of its own, from its side's
checkout: this one, and with --root the one unpacked at DIR (`git
archive` of another commit), in the order root, this.  The children:
config4 (7680x4320 u16, the default front then the fused one in one
process, as phase 11 runs them), config5_cli and config5_multi at
16384x16385 (the latter given a stand-in reference file, so that no
reference encode runs in the child after its two processes).  While a
child runs, this process samples torch.cuda.mem_get_info every 2 ms:
`device_peak_mib` is the most device memory in use by all processes,
less what was in use before the child started (this process's own CUDA
context).  The child reports its own torch.cuda.max_memory_reserved
(config4's encodes run in it), and where its version records them
(scale.py's peak_reserved_mib and graphs) each process's reserved peak
and the device memory its CUDA graphs kept.  Every run's file digest
must equal the other side's.  Prints the card's name and power limit,
one JSON line a child, then one summary line.

    python3 profile_memory.py --child CONFIG

is one child (run from its checkout's root).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = ("config4", "config5_cli", "config5_multi")
W5, H5 = 16384, 16385


def child(config: str) -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    from hydrium_tpu_torch import encoder as E
    from hydrium_tpu_torch import scale

    assert scale.__file__.startswith(os.getcwd()), scale.__file__
    tmp = tempfile.TemporaryDirectory(prefix="hyd_mem_")
    E.reset_warm_state(os.path.join(tmp.name, "warm.npz"))
    if config == "config4":
        recs = [scale.config4(device="cuda", fused_front=f)
                for f in (False, True)]
    elif config == "config5_cli":
        recs = [scale.config5_cli(W5, H5, device="cuda", timeout=600)]
    else:
        recs = [scale.config5_multi(W5, H5, device="cuda", timeout=600,
                                    reference={"sha256": "", "bytes": 0})]
    tmp.cleanup()
    keep = ("peak_reserved_mib", "graphs", "wall_s", "seconds", "bytes")
    out = {"config": config, "root": os.getcwd(),
           "child_peak_reserved_mib": torch.cuda.max_memory_reserved() / 2**20,
           "sha256": [r["sha256"] for r in recs],
           "records": [{k: r[k] for k in keep if k in r} for r in recs],
           "processes": [{k: p[k] for k in keep if k in p}
                         for r in recs for p in r.get("per_process", [])]}
    print(json.dumps(out), flush=True)
    return 0


class DevicePeak:
    """The peak of the device memory in use (total less free, all
    processes), sampled every `interval` seconds on a thread."""

    def __init__(self, interval: float = 0.002) -> None:
        import torch

        self._torch = torch
        self.interval = interval
        self.base = self.peak = self._used()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _used(self) -> int:
        free, total = self._torch.cuda.mem_get_info()
        return total - free

    def _run(self) -> None:
        while not self._stop.is_set():
            self.peak = max(self.peak, self._used())
            time.sleep(self.interval)

    def __enter__(self) -> "DevicePeak":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._used())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, choices=CONFIGS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child)
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    torch.zeros(1, device="cuda")
    sides = [("this", HERE)]
    if args.root:
        sides = [("root", os.path.abspath(args.root)), ("this", HERE)]
    runs = []
    for label, cwd in sides:
        for config in CONFIGS:
            with DevicePeak() as peak:
                res = subprocess.run(
                    [sys.executable, os.path.join(HERE, __file__), "--child",
                     config], cwd=cwd, capture_output=True, text=True,
                    timeout=1500)
            if res.returncode != 0:
                print(res.stderr[-4000:], file=sys.stderr)
                return 1
            line = dict(json.loads(res.stdout.strip().splitlines()[-1]),
                        side=label,
                        device_peak_mib=(peak.peak - peak.base) / 2**20)
            print(json.dumps(line), flush=True)
            runs.append(line)
    summary = {"card": smi, "order": [label for label, _ in sides]}
    for config in CONFIGS:
        mine = [r for r in runs if r["config"] == config]
        if len({tuple(r["sha256"]) for r in mine}) != 1:
            print(f"{config}: the sides' files differ", file=sys.stderr)
            return 1
        for r in mine:
            summary[f"{config}_{r['side']}"] = {
                "device_peak_mib": r["device_peak_mib"],
                "child_peak_reserved_mib": r["child_peak_reserved_mib"],
                "process_peak_reserved_mib": [
                    p.get("peak_reserved_mib")
                    for p in r["processes"] or r["records"]]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "summary": summary}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
