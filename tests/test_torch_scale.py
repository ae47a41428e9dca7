"""BASELINE configs 4 and 5 on the port (hydrium_tpu_torch/scale.py), on
the CPU at small sizes: its fixtures against the JAX package's scripts,
config 4's 16-bit encode against hydrium_tpu's backend="jax" (front
patched to JAX's integers; unpatched, decode PSNR within 0.05 dB of
JAX's), the level-10 container, the CLI and two-process runs of config
5, and the command line."""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from functools import lru_cache

import numpy as np
import pytest

import hydrium_tpu.config as jax_config
import hydrium_tpu_torch as H
import hydrium_tpu_torch.config as torch_config
from hydrium_tpu import Encoder as JaxEncoder
from hydrium_tpu import ImageMetadata as JaxMeta
from hydrium_tpu import SampleFormat as JaxFmt
from hydrium_tpu import encode_image as jax_encode_image
from hydrium_tpu.utils import djxl
from hydrium_tpu.utils import pngio as jax_pngio
from hydrium_tpu_torch import scale
from hydrium_tpu_torch.parallel.multihost import encode_image_multihost
from hydrium_tpu_torch.utils import pngio
from test_e2e import make_image
from test_torch_e2e import jax_front, jax_native_ready, warm_state  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS_CLI = ("mpix_s", "seconds", "bytes", "sha256", "level10_container",
              "peak_rss_mb", "rss_base_mb", "rss_growth_mb", "ru_maxrss_mb",
              "rss_growth_share", "counters", "launches", "card", "kind")
FIELDS_PROC = ("rank", "wall_s", "peak_rss_mb", "rss_base_mb",
               "rss_growth_mb", "ru_maxrss_mb", "rss_growth_share", "bytes",
               "counters", "launches")


@pytest.fixture
def one_thread_children(monkeypatch):
    """Children of the scale module inherit one OpenMP thread each, as
    the test workers they run beside have."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _jax_synthetic():
    spec = importlib.util.spec_from_file_location(
        "config5_virtual", os.path.join(REPO, "scripts", "config5_virtual.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SyntheticImage


def _frame(img) -> np.ndarray:
    return img[0:img.shape[0], 0:img.shape[1]]


@pytest.mark.parametrize("window", [
    (slice(0, 256), slice(0, 256)),
    (slice(2048, 2304), slice(0, 2048)),
    (slice(37, 300), slice(1001, 1333)),
    (slice(2999, 3000), slice(5, 2999)),
])
def test_synthetic_image_equals_the_jax_script(window):
    """(a) aligned and misaligned windows, and a frame taller than wide
    cut from the JAX script's square one."""
    want = _jax_synthetic()(3000)[window]
    got = scale.SyntheticImage(3000)[window]
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    tall = scale.SyntheticImage(1400, 3000)
    assert tall.shape == (3000, 1400, 3)
    ys, xs = window
    xs = slice(xs.start, min(xs.stop, 1400))
    np.testing.assert_array_equal(tall[ys, xs], want[:, :xs.stop - xs.start])


def test_streamed_png_reads_back_through_both_readers(tmp_path):
    """(b) many strips and IDAT chunks; both packages' readers give the
    synthesized pixels."""
    img = scale.SyntheticImage(700, 301)
    path = tmp_path / "s.png"
    scale.write_png(str(path), img, rows=64, idat_bytes=4096)
    want = _frame(img)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(pngio.read_png(f), want)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(jax_pngio.read_png(f), want)


def test_config4_image_is_the_jax_scripts():
    img = scale.config4_image(40, 64)
    rng = np.random.default_rng(0)
    yy = np.arange(40, dtype=np.float32)[:, None, None]
    xx = np.arange(64, dtype=np.float32)[None, :, None]
    base = 32768 + 20000 * np.sin(xx / 211.0) * np.cos(yy / 97.0)
    want = np.clip(base + rng.normal(0, 2500, (40, 64, 3)), 0,
                   65535).astype(np.uint16)
    assert img.dtype == np.uint16
    np.testing.assert_array_equal(img, want)


C4 = (300, 2100)       # two LF groups, the second 52 columns wide


@lru_cache(maxsize=None)
def _jax_config4() -> bytes:
    """hydrium_tpu's Encoder(backend="jax") fed config4's send_tile
    calls."""
    assert jax_native_ready()
    h, w = C4
    img = scale.config4_image(h, w)
    enc = JaxEncoder(JaxMeta(width=w, height=h), backend="jax")
    out = bytearray()
    for ty in range((h + 2047) // 2048):
        for tx in range((w + 2047) // 2048):
            enc.send_tile(img[ty * 2048:(ty + 1) * 2048,
                              tx * 2048:(tx + 1) * 2048], tx, ty,
                          sample_fmt=JaxFmt.UINT16)
            out.extend(enc.take_output())
    return bytes(out)


def test_config4_bytes_equal_jax_with_jax_front(jax_front):
    """(c) the reduced u16 config 4, front patched to JAX's integers."""
    r = scale.config4(*C4, device="cpu")
    want = _jax_config4()
    assert r["sha256"] == hashlib.sha256(want).hexdigest()
    assert r["bytes"] == len(want)
    assert r["counters"]["lfg_packed"] == 2
    assert not r["counters"].get("lfg_fallback")
    assert r["dispatches"] == 2
    assert r["codestream_signature"] and not r["level10_container"]
    assert (r["h"], r["w"]) == C4
    for k in ("mpix_s", "seconds", "seconds_cold", "bpp", "stage_seconds",
              "launches", "card", "kind", "device"):
        assert k in r, k
    assert r["mpix_s"] > 0 and r["seconds_cold"] > 0
    assert r["card"] is None and r["device"] == "cpu"


def test_config4_psnr_within_jax(monkeypatch):
    """(c) unpatched: libjxl decodes config 4 at >= JAX's PSNR - 0.05 dB;
    and without libjxl the PSNR is null with its reason."""
    r = scale.config4(*C4, device="cpu")
    ref = scale.config4_image(*C4) / 65535.0
    want = djxl.psnr(ref, djxl.decode(_jax_config4()))
    assert r["psnr_note"] is None
    assert r["psnr_db"] >= want - 0.05, (r["psnr_db"], want)

    from hydrium_tpu_torch.utils import djxl as torch_djxl

    def missing():
        raise OSError("libjxl.so.0.7: cannot open shared object file")

    monkeypatch.setattr(torch_djxl, "_load", missing)
    psnr, why = scale._psnr(b"", ref)
    assert psnr is None and "libjxl" in why


def test_config4_needs_a_card_for_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        scale.config4(*C4)
    with pytest.raises(RuntimeError, match="CUDA"):
        scale.config5_cli(300, 200)


@pytest.fixture
def level10_small(monkeypatch):
    """The level-10 area threshold cut to 2^16 pixels in both packages."""
    monkeypatch.setattr(jax_config, "LEVEL10_AREA", 1 << 16)
    monkeypatch.setattr(torch_config, "LEVEL10_AREA", 1 << 16)


@pytest.mark.parametrize("h,w", [(300, 520), (260, 2100)])
def test_level10_file_equals_jax_and_decodes(jax_front, level10_small, h, w):
    """(d) one LF group and two: the port's one-frame file equals
    backend="jax"'s, starts with the level-10 box, libjxl decodes it,
    and the one-process encode_image_multihost gives the same bytes."""
    img = make_image(h, w, "smooth", seed=h + w)
    assert H.ImageMetadata(width=w, height=h).level10
    want = jax_encode_image(img, -1, backend="jax")
    got = H.encode_image(img, device="cpu")
    assert got == want
    assert got[:8] == b"\x00\x00\x00\x0cJXL "
    assert djxl.decode(got).shape == img.shape
    assert encode_image_multihost(img, device="cpu") == got


def test_level10_unpatched_threshold_is_one_row_over_2_28():
    assert not H.ImageMetadata(width=16384, height=16384).level10
    assert H.ImageMetadata(width=16384, height=16385).level10
    assert scale._level10(b"\x00\x00\x00\x0cJXL \r\n\x87\n")
    assert not scale._level10(b"\xff\x0a\x00\x00")


def _encode_frame(w, h) -> bytes:
    return H.encode_image(_frame(scale.SyntheticImage(w, h)), device="cpu")


def test_config5_cli_on_cpu(one_thread_children):
    """(e) the CLI child on a streamed PNG: the file of encode_image on
    the frame, every field present, the level-10 flag off."""
    w, h = 2100, 300
    r = scale.config5_cli(w, h, device="cpu", timeout=240)
    for k in FIELDS_CLI:
        assert k in r, k
    assert r["sha256"] == hashlib.sha256(_encode_frame(w, h)).hexdigest()
    assert r["codestream_signature"] and not r["level10_container"]
    assert r["counters"]["lfg_packed"] == 2
    assert r["peak_rss_mb"] >= r["rss_base_mb"] > 0
    assert r["rss_growth_mb"] == r["peak_rss_mb"] - r["rss_base_mb"]
    assert r["ru_maxrss_mb"] >= r["peak_rss_mb"] - 1


@pytest.mark.parametrize("reference", [False, True],
                         ids=["streaming_encoder", "given"])
def test_config5_multi_two_processes_on_cpu(one_thread_children, reference):
    """(f) two processes over gloo, three LF groups (presets 0-1 and 2):
    process 0's file equals the single-process streaming Encoder's (run
    here, or handed in as a digest) and encode_image's."""
    w, h = 4100, 200
    want = _encode_frame(w, h)
    ref = ({"sha256": hashlib.sha256(want).hexdigest(), "bytes": len(want)}
           if reference else None)
    r = scale.config5_multi(w, h, device="cpu", reference=ref, timeout=240)
    assert r["byte_identical"]
    assert r["sha256"] == hashlib.sha256(want).hexdigest()
    assert r["reference"]["source"] == ("config5_cli" if reference else
                                        "single-process streaming Encoder")
    procs = r["per_process"]
    assert [p["rank"] for p in procs] == [0, 1]
    assert [p["counters"]["lfg_packed"] for p in procs] == [2, 1]
    assert [p["bytes"] for p in procs] == [len(want), 0]
    for p in procs:
        for k in FIELDS_PROC:
            assert k in p, k
    assert r["dispatches"] == sum(p["dispatches"] for p in procs)


def test_failed_multi_child_fails_the_run(one_thread_children, tmp_path):
    """A child that exits non-zero raises with its error output."""
    with pytest.raises(RuntimeError, match="child exit 1"):
        scale._children([["multi", "127.0.0.1:1", "2", "0", "x", "8",
                           str(tmp_path / "o.jxl"), "cpu"]],
                         str(tmp_path), timeout=120)


def _run_cli(args, tmp_path, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               HYDRIUM_TORCH_WARM_CACHE=str(tmp_path / "warm.npz"))
    return subprocess.run([sys.executable, "-m", "hydrium_tpu_torch.scale",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_command_line_on_cpu(tmp_path):
    """(g) every config at a tiny size: exit 0, one JSON line each, the
    two config 5 files equal, and --out holds the same results."""
    out = tmp_path / "scale.json"
    res = _run_cli(["--device", "cpu", "--size", "2100", "--height", "260",
                    "--out", str(out)], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.strip().splitlines()]
    assert [r["config"] for r in lines] == list(scale.CONFIGS)
    assert not any("error" in r for r in lines)
    c4, cli, multi = lines
    assert (c4["h"], c4["w"]) == (260, 2100)
    assert multi["byte_identical"] and multi["sha256"] == cli["sha256"]
    assert multi["reference"]["source"] == "config5_cli"
    assert json.loads(out.read_text()) == {r["config"]: r for r in lines}
    assert not (tmp_path / "warm.npz").exists()


def test_command_line_without_a_card_fails(tmp_path):
    """--device cuda (the default) without a card: every config reports
    its error and the exit code is 1; no fallback to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _run_cli(["--only", "config4", "--only", "config5_multi",
                    "--size", "64"], tmp_path, timeout=120)
    assert res.returncode == 1, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.strip().splitlines()]
    assert [r["config"] for r in lines] == ["config4", "config5_multi"]
    assert all("CUDA" in r["error"] for r in lines)


def test_peak_rss_sampler_sees_a_transient():
    """The sampled peak holds 64 MiB mapped, touched and unmapped inside
    the block (an anonymous mapping: no allocator keeps it resident)."""
    import mmap
    import time

    with scale._PeakRss(interval=0.001) as peak:
        m = mmap.mmap(-1, 64 << 20)
        for i in range(0, len(m), mmap.PAGESIZE):
            m[i] = 1
        during = scale._rss_mb()
        time.sleep(0.05)
        m.close()
        after = scale._rss_mb()
    assert peak.mb >= during - 8, (peak.mb, during)
    assert peak.mb >= after + 32, (peak.mb, after)
