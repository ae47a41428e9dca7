"""The port's kernel build (hydrium_tpu_torch/ops/_kernels.py) driven by a
stand-in nvcc on the CPU: one compile per source, then one link, into
the hashed library path, leaving nothing else in the build directory."""

import os
import stat

import pytest

from hydrium_tpu_torch.ops import _kernels

# writes its argument list to the -o file; fails on a source named bad.cu
FAKE_NVCC = """#!/bin/sh
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
case "$*" in *bad.cu*) echo "bad.cu:1: error" >&2; exit 1;; esac
echo "$*" > "$out"
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("a.cu", "b.cu"):
        (src / name).write_text(f"// {name}\n")
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_kernels, "_SRC_DIR", src)
    monkeypatch.setattr(_kernels, "_BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_build_compiles_each_source_then_links(fake_tree):
    so = _kernels.library_path()
    assert _kernels.build() > 0
    link = so.read_text().split()
    assert "-shared" in link
    assert [os.path.basename(a) for a in link if a.endswith(".o")] == [
        "a.o", "b.o"]
    assert sorted(os.listdir(fake_tree / "build")) == [so.name]
    assert _kernels.build() == 0.0


def test_build_names_the_failing_source(fake_tree):
    (fake_tree / "csrc" / "bad.cu").write_text("// bad\n")
    with pytest.raises(RuntimeError, match="bad.cu"):
        _kernels.build()
    assert os.listdir(fake_tree / "build") == []
