"""Shared by the benchmark's CPU tests: tiny runs of a cell through
run.drive on device="cpu", past the look for a card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small enough for the CPU, large enough for several 256^2 groups and
# an edge row of tiles
SIZE = (264, 520)

# the mixes that PERF.md keeps for later, as workloads the tests run
# beside BENCHMARK.json's own: the tiled mode (all three kernels) and four
# clients, each with its own Encoder
LATER = [{"name": "tiled256.photo4k", "config": "u8_tiled256_fused",
          "traffic": "photo4k", "chips": 1, "why": "later"},
         {"name": "oneframe.smooth4k_c4", "config": "u8_oneframe",
          "traffic": "smooth4k_c4", "chips": 1, "why": "later"}]


def full_spec():
    """BENCHMARK.json with the LATER workloads added, in memory."""
    import json

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    have = {c["name"] for c in spec["configs"]}
    spec["configs"] += [{"name": w["config"],
                         "file": f"jxlbench/configs/{w['config']}.json"}
                        for w in LATER if w["config"] not in have]
    have = {w["name"] for w in spec["workloads"]}
    later = [w["name"] for w in LATER if w["name"] not in have]
    spec["workloads"] += [w for w in LATER if w["name"] in later]
    # a later workload reports every per-layer metric
    for m in spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += later
    return spec


def bench_cells():
    import json

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return tuple(w["name"] for w in spec["workloads"])


CELLS = tuple(w["name"] for w in full_spec()["workloads"])


@pytest.fixture
def tiny_run(tmp_path):
    from jxlbench import run

    spec = full_spec()

    def go(cell, trace=False, seed=2**31 + 7, spec=spec, seconds=0.2):
        import time

        return run.drive(spec, cell, seed, seconds, trace, str(tmp_path),
                         device="cpu", size=SIZE, t0=time.perf_counter(),
                         workers=2)
    return go
