"""Nothing the harness or the reference imports is jax, jaxlib, flax or
the JAX package hydrium_tpu (top-level names compared whole, so
hydrium_tpu_torch passes), and the reference imports nothing of the
program, hydrium_tpu_torch."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "hydrium_tpu"}


def _imported_tops(path: Path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_nothing_forbidden():
    for path in BENCH.rglob("*.py"):
        assert not (_imported_tops(path) & FORBIDDEN), path
    for path in (BENCH / "ref").rglob("*.py"):
        assert "hydrium_tpu_torch" not in _imported_tops(path), path


def _modules_after(code: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
        check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    tops = _modules_after(
        "import jxlbench.ref.decode, jxlbench.ref.front, "
        "jxlbench.ref.compare, jxlbench.ref.control")
    assert not tops & (FORBIDDEN | {"hydrium_tpu_torch"})


def test_a_run_loads_nothing_forbidden(tmp_path):
    tops = _modules_after(
        "import time\nfrom jxlbench import run\n"
        "spec = run.load_json(run.ROOT / 'BENCHMARK.json')\n"
        f"line = run.drive(spec, spec['workloads'][-1]['name'], 3, 0.1, True, "
        f"{str(tmp_path)!r}, device='cpu', size=(264, 520), "
        "t0=time.perf_counter(), workers=1)\n"
        "assert line is not None and line['correct']\n"
        "if __name__ != '__main__': raise SystemExit")
    assert "hydrium_tpu_torch" in tops
    assert not tops & FORBIDDEN
