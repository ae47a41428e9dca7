"""Whole-file checks of the port (hydrium_tpu_torch.encode_image) against
the JAX package's encode_image(..., backend="jax") on the CPU.

The port's float front flips a few truncations per million against
XLA's (see test_torch_front), and one flip changes the file, so whole
files are compared with the port's front replaced by the JAX package's
integers (pipeline.encode_lfg): everything from the integer front
outputs onward -- transport, packing, payload, the device-to-host copy,
the host walk, ANS and framing -- must then give the same bytes.
Unpatched, libjxl decodes the port's output at PSNR >= JAX's - 0.05 dB.
"""

import fcntl
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hydrium_tpu_torch
from hydrium_tpu import encode_image as jax_encode_image
from hydrium_tpu.jxl import native as jax_native
from hydrium_tpu.ops import pipeline as P
from hydrium_tpu.ops import tables
from hydrium_tpu.utils import djxl
from hydrium_tpu_torch import EncodeStats, ImageMetadata
from hydrium_tpu_torch import encoder as TE
from hydrium_tpu_torch.jxl.tokcode import TokenCodec
from hydrium_tpu_torch.ops import front as TF
from hydrium_tpu_torch.ops import packed as TP
from test_e2e import make_image


def jax_native_ready() -> bool:
    """Build the JAX package's native plane (build/libhydtpu.so) under a
    file lock and forget a load error cached by a lost race.  Its loader
    builds without a lock, so test workers that start together on a
    checkout without build/ race, and a loser's cached error turns the
    plane off for its whole process: its backend="jax" encodes, which
    these tests hold the port to, would then take another path."""
    if jax_native._lib is not None:
        return True
    build_dir = os.path.dirname(jax_native._SO_PATH)
    try:
        os.makedirs(build_dir, exist_ok=True)
        with open(os.path.join(build_dir, ".libhydtpu.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            for attempt in range(2):
                # the second attempt rebuilds over a library that a build
                # racing outside the lock left truncated
                if (attempt or not os.path.exists(jax_native._SO_PATH)
                        or os.path.getmtime(jax_native._SO_PATH)
                        < os.path.getmtime(jax_native._SRC_PATH)):
                    jax_native._build()
                jax_native._load_error = None
                if jax_native.available():
                    return True
    except (OSError, subprocess.CalledProcessError):
        pass    # no g++ or an unwritable build/: the tests say so
    return False


# every test worker builds the JAX package's native plane, or waits for
# it, here (the port builds its own under a lock of its own)
jax_native_ready()

# One intra-op thread for torch on the CPU, in every process that
# collects this file (each test worker does).  Workers run side by side;
# with an OpenMP team per worker as wide as the machine, the teams'
# idle threads spin against each other and the port's small CPU tensors
# take tens of times longer (three tiled tests: 28 s at one thread, over
# 400 s at the default, six workers on eight cores).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_VIEWS = {"tokens": np.int16, "residues": np.int32, "lf_res": np.int32}


def jax_front_tokens(front, pixels, height, width, presets, *, buf_h, buf_w,
                     linear_light, sample_kind, clusters_per_preset,
                     lf_seg_vb=0, fused=False):
    """Drop-in for front.front_tokens that runs JAX encode_lfg (its XLA
    branch, whichever front `fused` asks for)."""
    out = P.encode_lfg(jnp.asarray(pixels.cpu().numpy()), height, width,
                       jnp.asarray(presets.cpu().numpy()),
                       jnp.asarray(tables.hf_cluster_map(1)), buf_h=buf_h,
                       buf_w=buf_w, linear_light=linear_light,
                       num_clusters=clusters_per_preset,
                       sample_kind=sample_kind, lf_seg_vb=lf_seg_vb,
                       clusters_per_preset=clusters_per_preset)
    res = {}
    for k, v in out.items():
        if k != "hist":
            a = np.array(v)
            res[k] = torch.tensor(a.view(_VIEWS.get(k, a.dtype)),
                                  device=pixels.device)
    return res


@pytest.fixture
def jax_front(monkeypatch):
    monkeypatch.setattr(TF, "front_tokens", jax_front_tokens)


@pytest.fixture(autouse=True)
def warm_state(tmp_path, monkeypatch):
    """The process-wide transport codec and wide hints, kept apart from
    ~/.cache and from other tests: a cache path under tmp_path, no
    hints, and a codec that is already warm (one flat histogram folded
    in), so that dispatch counts hold no cold-start bootstrap.  A test
    of the cold start calls TE.reset_warm_state() itself.  The port's
    test files that make an Encoder import this fixture."""
    codec = TokenCodec()
    codec.update(np.full((10, 64), 50))
    monkeypatch.setattr(TE, "_WARM_CACHE", str(tmp_path / "warm" / "warm.npz"))
    monkeypatch.setattr(TE, "_SHARED_CODEC", codec)
    monkeypatch.setattr(TE, "_WIDE_HINT", {})
    yield
    # an Encoder that a test abandons (it raised) may still have
    # dispatches on the prep pool: let them end while this test's
    # patches hold, so that none reaches the next test's
    prep_pool_idle()


def prep_pool_idle(timeout: float = 60) -> None:
    """Return once every task submitted to the prep pool so far has
    ended: one barrier task per worker, all running at once, means
    every worker is past what was queued before them."""
    pool = TE._PREP_POOL
    if pool is None:
        return
    n = pool._max_workers
    barrier = threading.Barrier(n)
    for fut in [pool.submit(barrier.wait, timeout) for _ in range(n)]:
        fut.result(timeout)


IMAGES = [(256, 256, "noise"), (100, 70, "smooth"), (300, 520, "noise"),
          (300, 2100, "smooth"), (8, 8, "smooth"), (1, 1, "smooth"),
          (7, 9, "smooth"), (256, 1, "smooth"), (1, 256, "smooth"),
          (257, 255, "smooth")]


@pytest.mark.parametrize("h,w,kind", IMAGES)
def test_bytes_equal_jax_backend_with_jax_front(jax_front, h, w, kind):
    img = make_image(h, w, kind, seed=h * 7 + w)
    want = jax_encode_image(img, -1, backend="jax")
    stats = EncodeStats()
    got = hydrium_tpu_torch.encode_image(img, device="cpu", stats=stats)
    assert got == want
    n_lfg = ((h + 2047) // 2048) * ((w + 2047) // 2048)
    assert stats.counters["lfg_packed"] == n_lfg
    assert stats.counters.get("lfg_fallback", 0) == 0


@pytest.mark.parametrize("h,w,kind", [(300, 520, "noise"),
                                      (300, 2100, "smooth")])
def test_decodes_at_jax_psnr(h, w, kind):
    img = make_image(h, w, kind, seed=h + w)
    mine = hydrium_tpu_torch.encode_image(img, device="cpu")
    ref = jax_encode_image(img, -1, backend="jax")
    dec = djxl.decode(mine)
    assert dec.shape == img.shape
    p = djxl.psnr(img / 255.0, dec)
    p_jax = djxl.psnr(img / 255.0, djxl.decode(ref))
    assert p >= p_jax - 0.05, (p, p_jax)


def _forced_ok(monkeypatch, first_ok):
    """pack_payload whose FIRST call reports ok word `first_ok` (the aux
    checksum excludes word 0, so the payload stays verifiable)."""
    real = TP.pack_payload
    calls = []

    def patched(*a, **k):
        out = real(*a, **k)
        if not calls:
            out[0] = first_ok
        calls.append(k["wide_residues"])
        return out

    monkeypatch.setattr(TP, "pack_payload", patched)
    return calls


def test_unpacked_fallback_gives_same_bytes(jax_front, monkeypatch):
    img = make_image(300, 520, "noise", seed=21)
    want = jax_encode_image(img, -1, backend="jax")
    _forced_ok(monkeypatch, 0)
    stats = EncodeStats()
    got = hydrium_tpu_torch.encode_image(img, device="cpu", stats=stats)
    assert got == want
    assert stats.counters["lfg_fallback"] == 1


def test_wide_retry_gives_same_bytes(jax_front, monkeypatch):
    img = make_image(300, 520, "noise", seed=22)
    want = jax_encode_image(img, -1, backend="jax")
    calls = _forced_ok(monkeypatch, 2)
    stats = EncodeStats()
    got = hydrium_tpu_torch.encode_image(img, device="cpu", stats=stats)
    assert got == want
    assert calls == [False, True]
    assert stats.counters["wide_retries"] == 1
    assert stats.counters["lfg_packed"] == 1


def test_checksum_mismatch_raises(monkeypatch):
    real = TP.pack_payload

    def corrupt(*a, **k):
        out = real(*a, **k)
        out[9] += 1               # an aux histogram word
        return out

    monkeypatch.setattr(TP, "pack_payload", corrupt)
    with pytest.raises(RuntimeError, match="checksum"):
        hydrium_tpu_torch.encode_image(make_image(64, 64, "noise"),
                                       device="cpu")


def test_scope_limits_raise():
    """Tiled mode is in scope (test_torch_tiled); a tile outside the
    image and a card that is not there still raise."""
    img = make_image(64, 64, "smooth")
    assert hydrium_tpu_torch.encode_image(img, tile_size_shift=0,
                                          device="cpu")[:2] == b"\xff\x0a"
    enc = hydrium_tpu_torch.Encoder(ImageMetadata(64, 64, tile_size_shift_x=1,
                                                  tile_size_shift_y=1),
                                    device="cpu")
    with pytest.raises(ValueError, match="out of bounds"):
        enc.send_tile(img, 1, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            hydrium_tpu_torch.encode_image(img, device="cuda")


def test_port_imports_no_jax(tmp_path):
    code = ("import sys, numpy as np, hydrium_tpu_torch\n"
            "img = np.random.default_rng(0).integers(0, 256, (40, 300, 3),"
            " dtype=np.uint8)\n"
            "b = hydrium_tpu_torch.encode_image(img, device='cpu')\n"
            "assert b[:2] == b'\\xff\\x0a', b[:2]\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('jaxlib'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO,
               HYDRIUM_TORCH_WARM_CACHE=str(tmp_path / "warm.npz"))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
