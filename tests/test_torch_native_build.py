"""The port's native serialization plane (hydrium_tpu_torch/jxl/native.py)
on a checkout without build/: processes that start together (as test
workers do) all load the library that one of them built under the
lock, build/torch_host/libhydtpu.so; and a library that another source
left there is rebuilt (the hash file beside it decides, not file
times)."""

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


def test_library_of_another_source_is_rebuilt(tmp_path):
    """A libhydtpu.so that an older source left in build/ (no hash file
    beside it, or another hash), newer than the source by its file time:
    the loader rebuilds it, and the rebuilt library has the PNG
    defilter that the readers call."""
    shutil.copytree(os.path.join(REPO, "hydrium_tpu_torch"),
                    tmp_path / "hydrium_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    host = tmp_path / "build" / "torch_host"
    host.mkdir(parents=True)
    (host / "libhydtpu.so").write_bytes(b"not a library")
    code = ("import numpy as np\n"
            "from hydrium_tpu_torch.jxl import native\n"
            "assert native.available(), native._load_error\n"
            "row = np.arange(12, dtype=np.uint8)\n"
            "native.png_unfilter(row, None, 3, 1)\n"
            "print(row.tolist())\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    want = "[0, 1, 2, 3, 5, 7, 9, 12, 15, 18, 22, 26]"
    for stale_hash in (None, "0" * 64):
        if stale_hash is not None:
            (host / "libhydtpu.so.hash").write_text(stale_hash)
            (host / "libhydtpu.so").write_bytes(b"not a library")
        res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode == 0, res.stderr
        assert res.stdout.strip() == want
        assert len((host / "libhydtpu.so.hash").read_text()) == 64
        assert (host / "libhydtpu.so").stat().st_size > 10000
