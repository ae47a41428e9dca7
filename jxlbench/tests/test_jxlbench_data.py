"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric added as new files (and entries) in a copy of the
benchmark are found by name and run, with no existing file edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

METRIC = '''"""A metric added as a file: images the window completed."""


def read(r):
    return float(len(r.window.images))
'''


def _digests(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((root / "jxlbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_traffic_and_metric_run_from_files(tmp_path):
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copytree(BENCH, copy / "jxlbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(copy)

    cfg = json.loads((BENCH / "configs" / "u8_oneframe.json").read_text())
    cfg.update(name="u8_oneframe_fused", fused_front=True)
    (copy / "jxlbench/configs/u8_oneframe_fused.json").write_text(
        json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "smooth4k_c4.json").read_text())
    mix.update(clients=2, pool=2)
    (copy / "jxlbench/traffic/smooth_c2.json").write_text(json.dumps(mix))
    (copy / "jxlbench/metrics/images_done.py").write_text(METRIC)
    spec["configs"].append({"name": "u8_oneframe_fused", "source": "x",
                            "file": "jxlbench/configs/u8_oneframe_fused.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "oneframe_fused.smooth_c2",
                              "config": "u8_oneframe_fused",
                              "traffic": "smooth_c2", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "images_done", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "encoder", "moves": "mpix_s",
                              "workloads": ["oneframe_fused.smooth_c2"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))

    code = (
        "import json, sys, time\nfrom jxlbench import run\n"
        "spec = run.load_json(run.ROOT / 'BENCHMARK.json')\n"
        "out = []\n"
        "for tr in (False, True):\n"
        "    out.append(run.drive(spec, 'oneframe_fused.smooth_c2', 9, 0.2, "
        f"tr, {str(tmp_path)!r}, device='cpu', size=(264, 520), "
        "t0=time.perf_counter(), workers=1))\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=f"{copy}{os.pathsep}{ROOT}")
    res = subprocess.run([sys.executable, "-c", code], cwd=copy, env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = json.loads(res.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert plain["attempted"] >= 2          # both clients finished images
    assert set(plain["metrics"]) == {"mpix_s", "file_bpp", "setup_s"}
    assert traced["metrics"]["images_done"]["value"] == traced["attempted"]
    after = _digests(copy)
    assert {k: after[k] for k in before} == before
