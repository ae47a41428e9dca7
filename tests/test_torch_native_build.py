"""hydrium_tpu_torch.host.ensure_native on a checkout without build/:
processes that start together (as test workers do) all get the native
serialization plane, where the JAX package's unlocked first build lets
some of them lose it."""

import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_concurrent_first_builds_all_load(tmp_path):
    for d in ("hydrium_tpu", "hydrium_tpu_torch", "cpp"):
        shutil.copytree(os.path.join(REPO, d), tmp_path / d,
                        ignore=shutil.ignore_patterns("__pycache__", "build"))
    assert not (tmp_path / "build").exists()
    # host.py loads by path (the package would import torch first) and
    # every process waits for one wall-clock instant, so that the four
    # first loads start together
    code = ("import importlib.util, sys, time\n"
            "spec = importlib.util.spec_from_file_location(\n"
            "    'host', 'hydrium_tpu_torch/host.py')\n"
            "host = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(host)\n"
            "time.sleep(max(0.0, float(sys.argv[1]) - time.time()))\n"
            "print(host.ensure_native(), host.native.available(),\n"
            "      host.native._SO_PATH)\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    start = f"{time.time() + 3.0:.3f}"
    procs = [subprocess.Popen([sys.executable, "-c", code, start],
                              cwd=tmp_path,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    so = str(tmp_path / "build" / "libhydtpu.so")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["True", "True", so], (out, err)
