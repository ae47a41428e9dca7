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

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hydrium_tpu_torch
from hydrium_tpu import encode_image as jax_encode_image
from hydrium_tpu.config import ImageMetadata
from hydrium_tpu.ops import pipeline as P
from hydrium_tpu.ops import tables
from hydrium_tpu.utils import djxl
from hydrium_tpu.utils.stats import EncodeStats
from hydrium_tpu_torch.ops import front as TF
from hydrium_tpu_torch.ops import packed as TP
from test_e2e import make_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_VIEWS = {"tokens": np.int16, "residues": np.int32, "lf_res": np.int32}


def jax_front_tokens(front, pixels, height, width, presets, *, buf_h, buf_w,
                     linear_light, sample_kind, clusters_per_preset,
                     lf_seg_vb=0):
    """Drop-in for front.front_tokens that runs JAX encode_lfg."""
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
    img = make_image(64, 64, "smooth")
    with pytest.raises(NotImplementedError):
        hydrium_tpu_torch.encode_image(img, tile_size_shift=0, device="cpu")
    with pytest.raises(NotImplementedError):
        hydrium_tpu_torch.Encoder(ImageMetadata(64, 64, tile_size_shift_x=1,
                                                tile_size_shift_y=1),
                                  device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            hydrium_tpu_torch.encode_image(img, device="cuda")


def test_port_imports_no_jax():
    code = ("import sys, numpy as np, hydrium_tpu_torch\n"
            "img = np.random.default_rng(0).integers(0, 256, (40, 300, 3),"
            " dtype=np.uint8)\n"
            "b = hydrium_tpu_torch.encode_image(img, device='cpu')\n"
            "assert b[:2] == b'\\xff\\x0a', b[:2]\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('jaxlib'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
