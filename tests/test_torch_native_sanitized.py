"""The port's native serialization plane under ASAN and UBSAN: its
standalone self-test (hydrium_tpu_torch/csrc/host/selftest.cc) built
with its serializer.cc into build/torch_host/selftest_asan, then run.
It builds under the lock that jxl/native.py builds the library under,
and again whenever either source or the flags change.  It skips only
where g++ is missing or cannot link a program with the sanitizers; a
failed build or run is a failure."""

import fcntl
import hashlib
import os
import shutil
import subprocess

import pytest

from hydrium_tpu_torch.jxl import native

HOST = os.path.dirname(native._SRC_PATH)
SOURCES = [native._SRC_PATH, os.path.join(HOST, "selftest.cc")]
BINARY = os.path.join(native._BUILD_DIR, "selftest_asan")
# HYD_SELFTEST builds in the self-test's thread counter
FLAGS = ["-O1", "-g", "-std=c++17", "-pthread", "-DHYD_SELFTEST",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all"]


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _build() -> None:
    """Build BINARY unless its hash file names these sources and flags."""
    os.makedirs(native._BUILD_DIR, exist_ok=True)
    with open(os.path.join(native._BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        digest = _digest()
        try:
            with open(BINARY + ".hash") as f:
                if f.read().strip() == digest and os.path.exists(BINARY):
                    return
        except OSError:
            pass
        tmp = f"{BINARY}.{os.getpid()}.tmp"
        try:
            res = subprocess.run(["g++", *FLAGS, *SOURCES, "-o", tmp],
                                 capture_output=True, text=True,
                                 timeout=600)
            assert res.returncode == 0, res.stderr[-4000:]
            os.replace(tmp, BINARY)
            with open(tmp, "w") as f:
                f.write(digest)
            os.replace(tmp, BINARY + ".hash")
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


@pytest.fixture
def sanitizers(tmp_path):
    """Skip, naming the reason, where this machine cannot build a
    sanitized program at all."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    probe = tmp_path / "probe.cc"
    probe.write_text("int main() { return 0; }\n")
    res = subprocess.run(["g++", *FLAGS, str(probe), "-o",
                          str(tmp_path / "probe")],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        pytest.skip("g++ cannot link with -fsanitize=address,undefined: "
                    + res.stderr.strip()[-300:])


def test_selftest_passes_under_asan_and_ubsan(sanitizers):
    _build()
    res = subprocess.run([BINARY], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr[-4000:]
    lines = res.stdout.splitlines()
    for stage in ("prefix streams ok", "hf padded ok", "hf packed ok",
                  "lf decode ok", "lf decode corrupt ok", "png unfilter ok"):
        assert stage in lines, res.stdout
    assert lines[-1] == "selftest passed"

