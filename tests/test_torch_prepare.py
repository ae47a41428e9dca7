"""The port's dispatch-preparation pool on the CPU: two "hyd-prep"
workers upload and enqueue every dispatch (encoder._prep_pool, the twin
of hydrium_tpu's _prep_pool), so the caller's send_tile returns once its
pixels are copied.  Held to: send_tile returning while a dispatch is
held, the caller reusing its buffer at once, every first dispatch on a
prep worker (re-dispatches on the fetch thread), a worker's error
reaching the caller, and the same bytes as backend="jax" (the port's
front replaced by the JAX package's integers) on every entry point."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import hydrium_tpu_torch as H
from hydrium_tpu import cli as jax_cli
from hydrium_tpu import encode_image as jax_encode_image
from hydrium_tpu.parallel import shard as jax_shard
from hydrium_tpu.parallel.driver import \
    encode_image_sharded as jax_encode_image_sharded
from hydrium_tpu_torch import (NEED_MORE_OUTPUT, BufferedEncoder, EncodeStats,
                               Encoder, ImageMetadata, cli)
from hydrium_tpu_torch import encoder as TE
from hydrium_tpu_torch.ops import packed as TP
from hydrium_tpu_torch.parallel.driver import encode_image_sharded
from test_e2e import make_image
from test_torch_cli import _write_png
from test_torch_e2e import jax_front, warm_state  # noqa: F401 (fixtures)
from test_torch_overlap import (WIDE, wide_image,  # noqa: F401 (fixtures)
                                wide_jax_bytes)
from test_torch_parallel import _wide
from test_torch_tiled import _tiles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a tiled frame with a stacked chunk and edge tiles: row 0 is one chunk
# of two full tiles and one edge tile, row 1 three edge tiles (44 rows)
TILED = (300, 600)
HOLD_S = 10     # a held dispatch fails by itself after this long


class PrepFailure(Exception):
    """What the gate raises on the dispatch it was told to fail."""


class _Gate:
    """encode_lfg_packed that records the name of the thread it runs on,
    waits while held (failing by itself after HOLD_S), then raises for
    the unit at (x, y) `fail_at` or calls through.  A unit is named by
    its geometry's (x, y), which _TorchDispatch._dispatch hands down:
    two workers enter in either order, so a call count names none."""

    def __init__(self, monkeypatch, held=False, fail_at=None):
        self.threads = []
        self.entered = threading.Event()
        self.release = threading.Event()
        if not held:
            self.release.set()
        lock = threading.Lock()
        unit = threading.local()
        real = TP.encode_lfg_packed
        real_dispatch = TE._TorchDispatch._dispatch

        def dispatch(handle):
            unit.at = (handle.lfg.x, handle.lfg.y)
            return real_dispatch(handle)

        def gate(*a, **k):
            with lock:
                self.threads.append(threading.current_thread().name)
            self.entered.set()
            if not self.release.wait(HOLD_S):
                raise TimeoutError("dispatch held past its release")
            if unit.at == fail_at:
                raise PrepFailure(f"dispatch at {unit.at}")
            return real(*a, **k)

        monkeypatch.setattr(TE._TorchDispatch, "_dispatch", dispatch)
        monkeypatch.setattr(TP, "encode_lfg_packed", gate)

    def on_prep(self) -> bool:
        return bool(self.threads) and all(t.startswith("hyd-prep")
                                          for t in self.threads)


def _send_strips(enc, img, first=0, zero=False) -> bytes:
    """send_tile each 2048-wide strip of img from strip `first` on, a
    copy each, zeroed right after send_tile returns when `zero`."""
    out = bytearray()
    for tx in range(first, (img.shape[1] + 2047) // 2048):
        strip = img[:, tx * 2048:(tx + 1) * 2048].copy()
        enc.send_tile(strip, tx, 0)
        if zero:
            strip[:] = 0
        out.extend(enc.take_output())
    return bytes(out)


def test_send_tile_returns_while_its_dispatch_is_held(
        jax_front, monkeypatch, wide_image, wide_jax_bytes):
    """The first LF group's enqueue is held on a prep worker: send_tile
    returns before it ends (released only after the return), the
    caller zeroes its strip at once, and the file is unchanged."""
    gate = _Gate(monkeypatch, held=True)
    h, w = WIDE
    enc = Encoder(ImageMetadata(width=w, height=h), device="cpu")
    strip = wide_image[:, :2048].copy()
    try:
        enc.send_tile(strip, 0, 0)
        returned_while_held = not gate.release.is_set()
        strip[:] = 0
        assert gate.entered.wait(HOLD_S)
        assert not enc._pending[0][1].done()
    finally:
        gate.release.set()
    assert returned_while_held
    out = enc.take_output() + _send_strips(enc, wide_image, 1)
    assert out == wide_jax_bytes
    assert gate.on_prep()


def test_caller_reuses_its_strips_while_the_workers_are_held(
        jax_front, monkeypatch, wide_image, wide_jax_bytes):
    """Four LF groups sent (a window of five) while both prep workers
    are held, each strip zeroed as soon as send_tile returns; the last
    one drains them all after the release."""
    monkeypatch.setenv("HYDRIUM_INFLIGHT", "5")
    gate = _Gate(monkeypatch, held=True)
    h, w = WIDE
    enc = Encoder(ImageMetadata(width=w, height=h), device="cpu")
    try:
        for tx in range(4):
            strip = wide_image[:, tx * 2048:(tx + 1) * 2048].copy()
            enc.send_tile(strip, tx, 0)
            strip[:] = 0
        assert gate.entered.wait(HOLD_S)
        held = (len(enc._pending),
                sum(f.done() for _tag, f in enc._pending))
    finally:
        gate.release.set()
    assert held == (4, 0)
    enc.send_tile(wide_image[:, 4 * 2048:], 4, 0)
    assert enc.take_output() == wide_jax_bytes


def test_every_dispatch_is_enqueued_on_a_prep_worker(jax_front, monkeypatch,
                                                    wide_image,
                                                    wide_jax_bytes):
    """One-frame LF groups, stacked chunks and edge tiles: the enqueue
    runs on hyd-prep, its timeline events too, and its time is the
    workers' stage "prepare"."""
    gate = _Gate(monkeypatch)
    stats = EncodeStats()
    stats.enable_timeline()
    assert H.encode_image(wide_image, device="cpu",
                          stats=stats) == wide_jax_bytes
    assert len(gate.threads) == 5 and gate.on_prep()
    img = make_image(*TILED, "noise", seed=50)
    want = jax_encode_image(img, 0, backend="jax")
    assert H.encode_image(img, 0, device="cpu", stats=stats) == want
    assert len(gate.threads) == 5 + 5 and gate.on_prep()
    # the caller's own stage "dispatch" carries the same name, on its
    # own thread
    caller = threading.current_thread().name
    spans = [(name, thread) for name, _t0, _t1, thread in stats.events
             if name.startswith(("h2d[", "dispatch[")) and thread != caller]
    assert len(spans) == 2 * 10
    assert all(t.startswith("hyd-prep") for _n, t in spans)
    assert {"dispatch", "prepare"} <= set(stats.stage_seconds)


@pytest.mark.parametrize("inflight", ["0", "3"])
@pytest.mark.parametrize("mode", ["one_frame", "tiled"])
def test_a_workers_error_reaches_the_caller(monkeypatch, wide_image, mode,
                                            inflight):
    """The second dispatch (LF group 1, or row 0's edge tile after its
    chunk) raises on its prep worker: the join that the fetch or the
    drain makes raises it to the caller, from the call that drains that
    unit; nothing retries it, and the encoder is not finished."""
    monkeypatch.setenv("HYDRIUM_INFLIGHT", inflight)
    fail_at = (1, 0) if mode == "one_frame" else (2, 0)
    gate = _Gate(monkeypatch, fail_at=fail_at)
    raised_at = None
    if mode == "one_frame":
        h, w = WIDE
        enc = Encoder(ImageMetadata(width=w, height=h), device="cpu")
        sends = [(lambda tx=tx: enc.send_tile(
            wide_image[:, tx * 2048:(tx + 1) * 2048], tx, 0))
            for tx in range(5)]
        expect = 1 if inflight == "0" else 4
    else:
        img = make_image(*TILED, "noise", seed=51)
        enc = Encoder(ImageMetadata(width=TILED[1], height=TILED[0],
                                    tile_size_shift_x=0,
                                    tile_size_shift_y=0), device="cpu")
        sends = [(lambda ty=ty: enc.send_tile_batch(
            _tiles(img, 256, 256, rows=[ty]))) for ty in range(2)]
        # the chunk, then the failing edge tile, both in row 0: a window
        # of 0 drains it in that call; otherwise two units are kept
        # until the last call drains them
        expect = 0 if inflight == "0" else 1
    for i, send in enumerate(sends):
        try:
            send()
        except PrepFailure as e:
            assert str(e) == f"dispatch at {fail_at}"
            raised_at = i
            break
    assert raised_at == expect
    assert not enc.finished
    assert gate.on_prep()


@pytest.mark.parametrize("inflight", ["0", "1", "3"])
def test_one_frame_window_bytes_with_the_pool(jax_front, monkeypatch,
                                              wide_image, wide_jax_bytes,
                                              inflight):
    monkeypatch.setenv("HYDRIUM_INFLIGHT", inflight)
    gate = _Gate(monkeypatch)
    h, w = WIDE
    enc = Encoder(ImageMetadata(width=w, height=h), device="cpu")
    assert _send_strips(enc, wide_image, zero=True) == wide_jax_bytes
    assert len(gate.threads) == 5 and gate.on_prep()


def test_tiled_with_edge_tiles_bytes_with_the_pool(jax_front, monkeypatch):
    gate = _Gate(monkeypatch)
    img = make_image(*TILED, "noise", seed=52)
    want = jax_encode_image(img, 0, backend="jax")
    enc = Encoder(ImageMetadata(width=TILED[1], height=TILED[0],
                                tile_size_shift_x=0, tile_size_shift_y=0),
                  device="cpu")
    out = bytearray()
    for ty in range(2):
        enc.send_tile_batch(_tiles(img, 256, 256, rows=[ty]))
        out.extend(enc.take_output())
    assert bytes(out) == want
    c = enc.stats.counters
    assert (c["lfg_packed"], len(gate.threads)) == (5, 5) and gate.on_prep()


def test_buffered_encoder_bytes_with_the_pool(jax_front, monkeypatch,
                                              wide_image, wide_jax_bytes):
    gate = _Gate(monkeypatch)
    h, w = WIDE
    be = BufferedEncoder(Encoder(ImageMetadata(width=w, height=h),
                                 device="cpu"))
    buf = bytearray(1 << 12)
    got = bytearray()
    be.provide_output_buffer(buf)
    for tx in range(5):
        st = be.send_tile(wide_image[:, tx * 2048:(tx + 1) * 2048], tx, 0)
        while st == NEED_MORE_OUTPUT:
            got.extend(buf[:be.release_output_buffer()])
            be.provide_output_buffer(buf)
            st = be.pump()
    got.extend(buf[:be.release_output_buffer()])
    assert be.finished and bytes(got) == wide_jax_bytes
    assert gate.on_prep()


def test_cli_bytes_with_the_pool(tmp_path, jax_front, monkeypatch):
    gate = _Gate(monkeypatch)
    arr = make_image(300, 2100, "noise", seed=53)
    png = tmp_path / "in.png"
    _write_png(png, arr)
    out, ref = tmp_path / "out.jxl", tmp_path / "ref.jxl"
    assert cli.main([str(png), str(out), "--device", "cpu"]) == 0
    assert jax_cli.main([str(png), str(ref), "--backend", "jax"]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert len(gate.threads) == 2 and gate.on_prep()


def test_sharded_bytes_with_the_pool(jax_front, monkeypatch):
    """Three LF groups over two entries with the call's own cold codec:
    the three dispatches on prep workers, the bootstrap's re-dispatch on
    the fetch thread that folded the histogram."""
    gate = _Gate(monkeypatch)
    img = _wide()
    want = jax_encode_image_sharded(img, mesh=jax_shard.make_mesh(2))
    stats = EncodeStats()
    assert encode_image_sharded(img, ["cpu", "cpu"], stats=stats) == want
    assert stats.counters["codec_bootstraps"] == 1
    assert sorted(t.split("_")[0] for t in gate.threads) == [
        "hyd-fetch", "hyd-prep", "hyd-prep", "hyd-prep"]


def test_an_abandoned_encoder_lets_the_process_exit(tmp_path):
    """The pool's workers are joined at interpreter exit: a process that
    leaves an encode with dispatches in flight still exits, at once."""
    code = ("import numpy as np, hydrium_tpu_torch as H\n"
            "img = np.random.default_rng(0).integers(0, 256, (64, 6200, 3),"
            " dtype=np.uint8)\n"
            "enc = H.Encoder(H.ImageMetadata(6200, 64), device='cpu')\n"
            "enc.send_tile(img[:, :2048], 0, 0)\n"
            "enc.send_tile(img[:, 2048:4096], 1, 0)\n"
            "print('left', len(enc._pending))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               HYDRIUM_TORCH_WARM_CACHE=str(tmp_path / "warm.npz"))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split() == ["left", "2"]


def test_the_pool_is_one_per_process_with_two_workers():
    pool = TE._prep_pool()
    assert pool is TE._prep_pool()
    assert pool._max_workers == 2
    assert pool._thread_name_prefix == "hyd-prep"
