"""The port's multi-process encode (hydrium_tpu_torch.parallel.multihost)
on the CPU: a real two-process gloo run against the port's
single-process streaming Encoder, one process against the JAX package's
encode_image_multihost (front patched to JAX's integers), and the
framing, partition, gather and retry pieces against their JAX twins."""

import json
import os
import socket
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from hydrium_tpu.parallel import multihost as jax_multihost
from hydrium_tpu_torch import EncodeStats, Encoder, ImageMetadata, SampleFormat
from hydrium_tpu_torch import encoder as TE
from hydrium_tpu_torch import host as TH
from hydrium_tpu_torch.parallel import multihost
from hydrium_tpu_torch.parallel.multihost import (
    _assign_presets, _pack_sections, _unpack_sections, encode_image_multihost,
    gather_bytes_to_host0, with_retry)
from multihost_child import make_image as make_wide
from test_torch_e2e import jax_front, warm_state  # noqa: F401 (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _streaming_bytes(img, linear=False) -> bytes:
    """The port's single-process Encoder(meta, device="cpu",
    streaming=True), LF groups sent in raster order."""
    fmt = {np.dtype(np.uint8): SampleFormat.UINT8}.get(
        img.dtype, SampleFormat.FLOAT32)
    h, w = img.shape[:2]
    enc = Encoder(ImageMetadata(width=w, height=h, linear_light=linear),
                  device="cpu", streaming=True)
    for ty in range((h + 2047) // 2048):
        for tx in range((w + 2047) // 2048):
            enc.send_tile(img[ty * 2048:(ty + 1) * 2048,
                              tx * 2048:(tx + 1) * 2048], tx, ty,
                          sample_fmt=fmt)
    return enc.take_output()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_processes(argvs, tmp_path, timeout=300):
    """Start one python process per argv (one thread each, the warm
    cache under tmp_path), wait for all; returns their stdouts.  Output
    goes to files, so that no process blocks on a full pipe while
    another waits for it in a collective."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               HYDRIUM_TORCH_WARM_CACHE=str(tmp_path / "warm.npz"))
    logs = [(tmp_path / f"proc{i}.out", tmp_path / f"proc{i}.err")
            for i in range(len(argvs))]
    procs = []
    try:
        for argv, (out, err) in zip(argvs, logs):
            with open(out, "w") as fo, open(err, "w") as fe:
                procs.append(subprocess.Popen([sys.executable] + argv,
                                              cwd=REPO, env=env, stdout=fo,
                                              stderr=fe))
        for p in procs:
            p.wait(timeout=timeout)
        for p, (_, err) in zip(procs, logs):
            assert p.returncode == 0, err.read_text()[-3000:]
        return [out.read_text() for out, _ in logs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.mark.parametrize("num_presets", [1, 2, 3, 7, 256])
def test_preset_assignment_partitions(num_presets):
    for n_proc in (1, 2, 3, 5):
        seen = []
        for pid in range(n_proc):
            mine = _assign_presets(num_presets, n_proc, pid)
            assert mine == jax_multihost._assign_presets(num_presets,
                                                         n_proc, pid)
            seen.extend(mine)
        assert seen == list(range(num_presets))


def _sections():
    rng = np.random.default_rng(7)
    lf = [(0, (b"\x01\x02\x03", 5, 3)), (2, (b"", 0, 0))]
    hf = [((0, 0), (bytes(rng.integers(0, 256, 40, np.uint8)), 1, 1)),
          ((2, 5), (b"\xff", 127, 7))]
    freqs = {0: rng.integers(0, 4096, 20).astype(np.uint32),
             3: np.zeros(0, np.uint32)}
    return lf, hf, freqs


def test_pack_sections_equals_jax_and_round_trips():
    lf, hf, freqs = _sections()
    blob = _pack_sections(lf, hf, freqs)
    assert blob == jax_multihost._pack_sections(lf, hf, freqs)
    got_lf, got_hf, got_freqs = _unpack_sections(blob)
    assert got_lf == dict(lf) and got_hf == dict(hf)
    assert sorted(got_freqs) == sorted(freqs)
    for c, f in freqs.items():
        np.testing.assert_array_equal(got_freqs[c], f)


@pytest.mark.parametrize("damage,match", [
    (lambda b: b"XSEC" + b[4:], "magic"),
    (lambda b: b[:10], "truncated"),
    (lambda b: b + b"\x00", "trailing"),
    (lambda b: b[:16] + struct.pack("<qIIQ", 0, 0, 0, 1 << 40) + b[36:],
     "past payload end"),
])
def test_unpack_sections_rejects_malformed_framing(damage, match):
    blob = _pack_sections(*_sections())
    with pytest.raises(ValueError, match=match):
        _unpack_sections(damage(blob))


def test_single_process_group_defaults():
    multihost.initialize("127.0.0.1:1", 1, 0)     # one process: a no-op
    multihost.initialize()
    assert multihost.process_count() == 1
    assert multihost.process_index() == 0
    assert gather_bytes_to_host0(b"abc") == [b"abc"]
    multihost.shutdown()


def test_with_retry_recovers_and_raises():
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return x + 1

    assert with_retry(flaky, attempts=3, backoff=0.0)(1) == 2
    calls["n"] = 0
    with pytest.raises(RuntimeError):
        with_retry(flaky, attempts=2, backoff=0.0)(1)


def test_multihost_single_process_matches_encoder():
    """One process: the streaming Encoder's bytes, with a codec of the
    call's own (cold: one bootstrap) that leaves the process's shared
    codec and its warm cache alone."""
    img = make_wide()
    shared = TE._SHARED_CODEC
    before = shared.freqs.copy()
    stats = EncodeStats()
    got = encode_image_multihost(img, device="cpu", stats=stats)
    assert stats.counters["lfg_packed"] == 3
    assert stats.counters["codec_bootstraps"] == 1
    np.testing.assert_array_equal(shared.freqs, before)
    assert not os.path.exists(TE._WARM_CACHE)
    assert got == _streaming_bytes(img)


@pytest.mark.parametrize("fmt", ["uint8", "float32_linear"])
def test_multihost_one_process_equals_jax(jax_front, fmt):
    img = make_wide()
    linear = fmt == "float32_linear"
    if linear:
        img = ((img / np.float32(255.0)) ** 2.2).astype(np.float32)
    kw = dict(linear_light=linear, sample_fmt=img.dtype.name)
    want = jax_multihost.encode_image_multihost(img, **kw)
    assert encode_image_multihost(img, device="cpu", **kw) == want


def test_multihost_retries_a_checksum_mismatch(monkeypatch):
    """The first payload check fails: with_retry recomputes the LF group
    (nothing was fed to the HF stream) and the bytes do not change."""
    img = make_wide()[:64]
    real = TH.packed_verify
    calls = []

    def fail_once(aux, words):
        calls.append(words is None)
        return len(calls) > 1 and real(aux, words)

    monkeypatch.setattr(TH, "packed_verify", fail_once)
    got = encode_image_multihost(img, device="cpu")
    assert calls[0] is True      # the aux check of the first dispatch
    assert got == _streaming_bytes(img)


def test_multihost_raises_once_the_attempts_are_spent(monkeypatch):
    monkeypatch.setattr(TH, "packed_verify", lambda aux, words: False)
    with pytest.raises(RuntimeError, match="checksum"):
        encode_image_multihost(make_wide()[:16], device="cpu", attempts=2)


def test_multihost_device_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_image_multihost(make_wide()[:16])


def test_multihost_two_processes_over_gloo(tmp_path):
    """A real two-process gloo run on localhost: process 0's file equals
    the single-process streaming Encoder's, and each process encoded its
    own presets' LF groups (3 LF groups, presets 0-1 and 2)."""
    img = make_wide()
    np.save(tmp_path / "img.npy", img)
    out = tmp_path / "multi.jxl"
    addr = f"127.0.0.1:{_free_port()}"
    outs = _run_processes(
        [["-m", "hydrium_tpu_torch.parallel.multihost", addr, "2", str(i),
          str(tmp_path / "img.npy"), str(out), "--device", "cpu"]
         for i in range(2)], tmp_path)
    recs = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [r["rank"] for r in recs] == [0, 1]
    assert [r["counters"]["lfg_packed"] for r in recs] == [2, 1]
    assert out.read_bytes() == _streaming_bytes(img)


GATHER_CHILD = """
import sys
from hydrium_tpu_torch.parallel import multihost as M
addr, rank = sys.argv[1], int(sys.argv[2])
M.initialize(addr, 3, rank)
assert (M.process_count(), M.process_index()) == (3, rank)
payload = bytes(range(256)) * (rank * 5) + bytes([rank]) * rank
got = M.gather_bytes_to_host0(payload if rank != 1 else b"")
M.shutdown()
if rank == 0:
    want = [bytes(range(256)) * (r * 5) + bytes([r]) * r for r in range(3)]
    want[1] = b""
    assert got == want, [len(g) for g in got]
else:
    assert got is None
print("ok", rank)
"""


def test_gather_bytes_over_three_processes(tmp_path):
    """Unequal lengths, one of them empty, padded for gloo and cut back."""
    addr = f"127.0.0.1:{_free_port()}"
    outs = _run_processes([["-c", GATHER_CHILD, addr, str(i)]
                           for i in range(3)], tmp_path)
    assert [o.strip() for o in outs] == [f"ok {i}" for i in range(3)]
