"""The port's native serialization plane (hydrium_tpu_torch/jxl/native.py)
on a checkout without build/: processes that start together (as test
workers do) all load the library that one of them built under the
lock, build/torch_host/libhydtpu.so."""

import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_concurrent_first_builds_all_load(tmp_path):
    shutil.copytree(os.path.join(REPO, "hydrium_tpu_torch"),
                    tmp_path / "hydrium_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    assert not (tmp_path / "build").exists()
    # every process waits for one wall-clock instant, so that the four
    # first loads start together
    code = ("import sys, time\n"
            "from hydrium_tpu_torch.jxl import native\n"
            "time.sleep(max(0.0, float(sys.argv[1]) - time.time()))\n"
            "print(native.available(), native._SO_PATH)\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    start = f"{time.time() + 8.0:.3f}"
    procs = [subprocess.Popen([sys.executable, "-c", code, start],
                              cwd=tmp_path,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    so = str(tmp_path / "build" / "torch_host" / "libhydtpu.so")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["True", so], (out, err)
    leftovers = [f for f in os.listdir(tmp_path / "build" / "torch_host")
                 if f.endswith(".tmp")]
    assert not leftovers, leftovers
