"""The port's overlapped dispatch and drain on the CPU: the in-flight
window (HYDRIUM_INFLIGHT), tiled units fetched on their own threads,
the process-wide transport codec with its cold-start bootstrap and its
warm state on disk, the sticky wide hint, and errors on worker threads.
None of them may change output bytes: whole files equal backend="jax"
with the port's front replaced by the JAX package's integers."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import hydrium_tpu_torch as H
from hydrium_tpu import encode_image as jax_encode_image
from hydrium_tpu_torch import Encoder, EncodeStats, ImageMetadata
from hydrium_tpu_torch import encoder as TE
from hydrium_tpu_torch.jxl.tokcode import TokenCodec
from hydrium_tpu_torch.ops import packed as TP
from test_e2e import make_image
from test_torch_e2e import (_forced_ok, jax_front,  # noqa: F401 (fixtures)
                            warm_state)
from test_torch_tiled import _per_tile, _tiles

# five LF groups in a row: more than the default window of three
WIDE = (72, 8300)


def _count_dispatches(monkeypatch):
    calls = []
    real = TP.pack_payload
    monkeypatch.setattr(TP, "pack_payload",
                        lambda *a, **k: calls.append(k["wide_residues"])
                        or real(*a, **k))
    return calls


@pytest.fixture(scope="module")
def wide_image():
    return make_image(*WIDE, "smooth", seed=40)


@pytest.fixture(scope="module")
def wide_jax_bytes(wide_image):
    return jax_encode_image(wide_image, -1, backend="jax")


@pytest.mark.parametrize("inflight", ["0", "1", "3"])
def test_window_sizes_give_the_jax_backends_bytes(jax_front, monkeypatch,
                                                  wide_image, wide_jax_bytes,
                                                  inflight):
    monkeypatch.setenv("HYDRIUM_INFLIGHT", inflight)
    h, w = WIDE
    enc = Encoder(ImageMetadata(width=w, height=h), device="cpu")
    assert enc.max_inflight == int(inflight)
    out = bytearray()
    for tx in range(5):
        strip = wide_image[:, tx * 2048:(tx + 1) * 2048].copy()
        enc.send_tile(strip, tx, 0)
        strip[:] = 0        # the caller may reuse its buffer at once
        if tx < 4:
            assert len(enc._pending) == min(tx + 1, int(inflight))
        out.extend(enc.take_output())
    assert enc.finished and not enc._pending
    assert bytes(out) == wide_jax_bytes
    assert enc.stats.counters["lfg_packed"] == 5
    assert "fetch_wait" in enc.stats.stage_seconds


def test_tiled_threaded_fetch_equals_per_tile_from_a_cold_codec(monkeypatch,
                                                               tmp_path):
    """Stacked chunks and edge tiles, each fetched on its own thread,
    two units kept across calls; the codec starts cold, so the first
    unit bootstraps: one more dispatch, the same bytes."""
    img = make_image(600, 1100, "noise", seed=41)
    want = _per_tile(img)
    TE.reset_warm_state(tmp_path / "cold" / "warm.npz")
    calls = _count_dispatches(monkeypatch)
    enc = Encoder(ImageMetadata(width=1100, height=600, tile_size_shift_x=0,
                                tile_size_shift_y=0), device="cpu")
    out = bytearray()
    for ty in range(3):
        enc.send_tile_batch(_tiles(img, 256, 256, rows=[ty]))
        assert len(enc._tb_units) <= 2
        out.extend(enc.take_output())
    assert bytes(out) == want
    c = enc.stats.counters
    assert c["codec_bootstraps"] == 1
    assert len(calls) == c["lfg_packed"] + c["codec_bootstraps"]
    assert "fetch_wait" in enc.stats.stage_seconds


def test_cold_codec_bootstraps_once_and_persists(jax_front, monkeypatch,
                                                 tmp_path, wide_image,
                                                 wide_jax_bytes):
    cache = tmp_path / "state" / "warm.npz"
    TE.reset_warm_state(cache)
    assert TE._shared_codec().cold
    calls = _count_dispatches(monkeypatch)
    first = EncodeStats()
    assert H.encode_image(wide_image, device="cpu",
                          stats=first) == wide_jax_bytes
    assert first.counters["codec_bootstraps"] == 1
    assert len(calls) == 5 + 1
    assert not TE._shared_codec().cold
    # a second Encoder in the same process shares the codec: warm
    second = EncodeStats()
    assert H.encode_image(wide_image, device="cpu",
                          stats=second) == wide_jax_bytes
    assert second.counters.get("codec_bootstraps", 0) == 0
    assert len(calls) == 5 + 1 + 5
    # the state was saved when the encodes finished; a fresh process
    # (here: the process's state forgotten) loads it and starts warm
    assert cache.exists()
    freqs = TE._shared_codec().freqs.copy()
    TE.reset_warm_state()
    assert TE._SHARED_CODEC is None
    codec = TE._shared_codec()
    assert not codec.cold
    np.testing.assert_array_equal(codec.freqs, freqs)
    third = EncodeStats()
    H.encode_image(wide_image[:, :300], device="cpu", stats=third)
    assert third.counters.get("codec_bootstraps", 0) == 0


def test_codec_save_then_load_round_trips(tmp_path):
    path = str(tmp_path / "sub" / "codec.npz")
    a = TokenCodec()
    assert a.cold
    a.update(np.zeros((10, 64), np.int64))      # an empty histogram
    assert a.cold
    a.update(np.random.default_rng(5).integers(0, 5000, (10, 64)))
    assert not a.cold
    a.save(path)
    b = TokenCodec(cache_path=path)
    assert not b.cold
    np.testing.assert_array_equal(a.freqs, b.freqs)
    for x, y in zip(a.tables(), b.tables()):
        np.testing.assert_array_equal(x, y)
    # no file, and a file of another format, leave the codec cold
    assert TokenCodec(cache_path=str(tmp_path / "none.npz")).cold
    old = str(tmp_path / "old.npz")
    np.savez(old, freqs=np.ones((9, 64), np.int64))
    assert TokenCodec(cache_path=old).cold


def test_tables_stay_whole_under_concurrent_updates():
    """Fetch threads fold histograms in while the dispatching thread
    takes tables(): every snapshot is one complete code (each codeword
    decodes to its own symbol and length through the same snapshot's
    LUT), never a mix of two."""
    codec = TokenCodec()
    rng = np.random.default_rng(6)
    hists = rng.integers(0, 5000, (8, 10, 64))
    stop = threading.Event()

    def feed():
        i = 0
        while not stop.is_set():
            codec.update(hists[i % 8])
            i += 1

    threads = [threading.Thread(target=feed) for _ in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    for t in threads:
        t.start()
    try:
        for _ in range(6):
            lens, codes, lut = codec.tables()
            for k in range(10):
                row = slice(k * 64, (k + 1) * 64)
                entry = lut[k, codes[row]]
                np.testing.assert_array_equal(entry & 0xFF, np.arange(64))
                np.testing.assert_array_equal(entry >> 8, lens[row])
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not codec.cold


def test_wide_hints_round_trip(tmp_path):
    TE.reset_warm_state(tmp_path / "w" / "warm.npz")
    TE._shared_codec().update(np.full((10, 64), 7))
    TE._WIDE_HINT[(512, 2048, "uint8")] = True
    TE._WIDE_HINT[(4096, 256, "float32")] = True
    TE._save_warm_state()
    with open(str(tmp_path / "w" / "warm.npz") + ".hints.json") as f:
        assert sorted(json.load(f)["wide"]) == ["4096x256xfloat32",
                                                "512x2048xuint8"]
    TE.reset_warm_state()
    assert not TE._WIDE_HINT
    TE._shared_codec()
    assert TE._WIDE_HINT == {(512, 2048, "uint8"): True,
                             (4096, 256, "float32"): True}


@pytest.mark.parametrize("shift,key", [(-1, (512, 768, "uint8")),
                                       (0, (4096, 256, "uint8"))])
def test_wide_retry_sets_a_sticky_hint(jax_front, monkeypatch, shift, key):
    """The first dispatch reports ok = 2: it retries wide and sets the
    hint for its (buffer shape, sample format); the next encode of that
    shape dispatches wide at once and counts no retry.  One LF group
    one-frame; one stacked chunk of six tiles tiled."""
    img = make_image(512, 768, "noise", seed=42)
    want = jax_encode_image(img, shift, backend="jax")
    calls = _forced_ok(monkeypatch, 2)
    first = EncodeStats()
    assert H.encode_image(img, shift, device="cpu", stats=first) == want
    assert first.counters["wide_retries"] == 1
    assert calls == [False, True]
    assert TE._WIDE_HINT == {key: True}
    second = EncodeStats()
    assert H.encode_image(img, shift, device="cpu", stats=second) == want
    assert second.counters.get("wide_retries", 0) == 0
    assert calls == [False, True, True]
    # another sample format of the same shape has no hint
    third = EncodeStats()
    H.encode_image(img.astype(np.uint16) * 257, shift, device="cpu",
                   stats=third)
    assert calls == [False, True, True, False]


def _corrupt_nth(monkeypatch, n):
    """pack_payload whose n-th call (from 0) fails its aux checksum."""
    real = TP.pack_payload
    calls = []

    def corrupt(*a, **k):
        out = real(*a, **k)
        if len(calls) == n:
            out[9] += 1               # an aux histogram word
        calls.append(1)
        return out

    monkeypatch.setattr(TP, "pack_payload", corrupt)


def _corrupt_lfg(monkeypatch, x):
    """pack_payload that fails its aux checksum in the dispatches of LF
    group (0, x), whichever order the two prep workers enqueue in."""
    real_pack, real_dispatch = TP.pack_payload, TE._TorchDispatch._dispatch
    local = threading.local()

    def dispatch(self):
        local.x = self.lfg.x
        try:
            return real_dispatch(self)
        finally:
            local.x = None

    def corrupt(*a, **k):
        out = real_pack(*a, **k)
        if getattr(local, "x", None) == x:
            out[9] += 1               # an aux histogram word
        return out

    monkeypatch.setattr(TE._TorchDispatch, "_dispatch", dispatch)
    monkeypatch.setattr(TP, "pack_payload", corrupt)


@pytest.mark.parametrize("inflight", ["0", "3"])
def test_worker_error_reaches_the_caller_one_frame(monkeypatch, wide_image,
                                                   inflight):
    """The second LF group's payload is corrupt: its fetch thread
    raises, the drain worker hands it on, and the caller gets it from
    the send_tile that drains that group, or from the one that
    finalizes."""
    monkeypatch.setenv("HYDRIUM_INFLIGHT", inflight)
    _corrupt_lfg(monkeypatch, 1)
    h, w = WIDE
    enc = Encoder(ImageMetadata(width=w, height=h), device="cpu")
    raised_at = None
    for tx in range(5):
        try:
            enc.send_tile(wide_image[:, tx * 2048:(tx + 1) * 2048], tx, 0)
        except RuntimeError as e:
            assert "checksum" in str(e)
            raised_at = tx
            break
    assert raised_at == (1 if inflight == "0" else 4)
    assert not enc.finished


def test_worker_error_reaches_the_caller_tiled(monkeypatch):
    img = make_image(512, 1024, "noise", seed=43)
    _corrupt_nth(monkeypatch, 0)        # the stacked chunk
    enc = Encoder(ImageMetadata(width=1024, height=512, tile_size_shift_x=0,
                                tile_size_shift_y=0), device="cpu")
    with pytest.raises(RuntimeError, match="checksum"):
        enc.send_tile_batch(_tiles(img, 256, 256))
    # an error on the render pool, too
    monkeypatch.undo()
    enc = Encoder(ImageMetadata(width=1024, height=512, tile_size_shift_x=0,
                                tile_size_shift_y=0), device="cpu")

    def broken(*a, **k):
        raise ZeroDivisionError("render")

    monkeypatch.setattr(enc, "_render_tiled_frame", broken)
    with pytest.raises(ZeroDivisionError):
        enc.send_tile_batch(_tiles(img, 256, 256))


def test_env_cache_path_is_read_at_import(tmp_path):
    cache = tmp_path / "env" / "warm.npz"
    code = ("import numpy as np, hydrium_tpu_torch as H\n"
            "from hydrium_tpu_torch import encoder as E\n"
            "s = H.EncodeStats()\n"
            "H.encode_image(np.zeros((40, 40, 3), np.uint8) + 9, "
            "device='cpu', stats=s)\n"
            "print(E._WARM_CACHE, s.counters.get('codec_bootstraps', 0))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo,
               HYDRIUM_TORCH_WARM_CACHE=str(cache))
    runs = [subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                           capture_output=True, text=True, timeout=300)
            for _ in range(2)]
    for r in runs:
        assert r.returncode == 0, r.stderr
    # the first process starts cold and saves; the second starts warm
    assert runs[0].stdout.split() == [str(cache), "1"]
    assert runs[1].stdout.split() == [str(cache), "0"]
    assert cache.exists()
