"""The port's multi-device encodes on the CPU (hydrium_tpu_torch.parallel
driver, shard and dryrun) against the port's single-device encode and
against the JAX package's parallel/* on the conftest's virtual CPU mesh.

Byte comparisons with the JAX package run with the port's front patched
to JAX's integers (test_torch_e2e.jax_front_tokens), as the port's other
whole-file tests do; comparisons within the port need no patch.  Frames
are kept a few hundred rows high so that several LF groups, ragged
edges included, encode in seconds on one CPU thread.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

import hydrium_tpu_torch
from hydrium_tpu.parallel import shard as jax_shard
from hydrium_tpu.parallel.driver import \
    encode_image_sharded as jax_encode_image_sharded
from hydrium_tpu_torch import EncodeStats
from hydrium_tpu_torch.jxl.tokcode import TokenCodec
from hydrium_tpu_torch.parallel import driver, dryrun, shard
from hydrium_tpu_torch.parallel.driver import encode_image_sharded
from multihost_child import make_image as make_wide
from test_e2e import make_image
from test_torch_e2e import (_forced_ok, jax_front,  # noqa: F401 (fixtures)
                            warm_state)

import __graft_entry__

_REF: dict = {}


def _wide(h=64):
    """multihost_child's 300x4100 frame cut to h rows: three LF groups
    (2048, 2048 and 4 columns wide)."""
    return np.ascontiguousarray(make_wide()[:h])


def _port_bytes(img) -> bytes:
    """The port's single-device encode of img (cached: bytes never depend
    on the codec state the tests vary)."""
    key = (img.shape, img.dtype.str, img.tobytes()[:64])
    if key not in _REF:
        _REF[key] = hydrium_tpu_torch.encode_image(img, device="cpu")
    return _REF[key]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_sharded_equals_single_device(k):
    """Three LF groups over k CPU entries: one per batch, a ragged last
    batch (k = 2), one batch (k = 3).  The call's own codec starts cold:
    one bootstrap dispatch."""
    img = _wide()
    stats = EncodeStats()
    got = encode_image_sharded(img, ["cpu"] * k, stats=stats)
    assert got == _port_bytes(img)
    assert stats.counters["lfg_packed"] == 3
    assert stats.counters["codec_bootstraps"] == 1
    assert not stats.counters.get("lfg_fallback")


@pytest.mark.parametrize("fmt", ["uint8", "float32_linear"])
def test_sharded_equals_jax_sharded(jax_front, fmt):
    """With the front patched to JAX's integers, over two entries on each
    side: 300x4100, ragged right and bottom edges; u8 sRGB and f32 with
    linear light."""
    img = make_wide()
    linear = fmt == "float32_linear"
    if linear:
        img = ((img / np.float32(255.0)) ** 2.2).astype(np.float32)
    kw = dict(linear_light=linear, sample_fmt=img.dtype.name)
    want = jax_encode_image_sharded(img, mesh=jax_shard.make_mesh(2), **kw)
    got = encode_image_sharded(img, ["cpu", "cpu"], **kw)
    assert got == want


def test_sharded_unpacked_fallback_gives_same_bytes(monkeypatch):
    """A payload that does not pack (ok word 0) runs the unpacked path
    on its own device; the bytes do not change.  The call's codec is
    warm here, so that the first payload is walked, not bootstrapped."""
    img = _wide()
    codec = TokenCodec()
    codec.update(np.full((10, 64), 50))
    monkeypatch.setattr(driver, "TokenCodec", lambda: codec)
    _forced_ok(monkeypatch, 0)
    stats = EncodeStats()
    got = encode_image_sharded(img, ["cpu", "cpu"], stats=stats)
    assert got == _port_bytes(img)
    assert stats.counters["lfg_fallback"] == 1


def test_sharded_single_group_frame_uses_encode_image():
    img = make_image(200, 256, "noise", seed=3)
    assert encode_image_sharded(img, ["cpu"] * 2) == \
        hydrium_tpu_torch.encode_image(img, device="cpu")


def test_sharded_defaults_to_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_image_sharded(_wide(16))
    with pytest.raises(RuntimeError, match="CUDA"):
        shard.make_devices()


@pytest.mark.parametrize("lfg_dim,num_presets", [(256, 1), (512, 2)])
def test_sharded_lfg_encode_equals_jax(jax_front, lfg_dim, num_presets):
    """Four LF groups over two entries on each side: every output and
    the summed histogram exactly equal."""
    rng = np.random.default_rng(lfg_dim)
    pixels = rng.integers(0, 256, (4, lfg_dim, lfg_dim, 3), dtype=np.uint8)
    presets = np.array([0, 1, 0, 1], np.int32) % num_presets
    kw = dict(lfg_dim=lfg_dim, linear_light=False, num_presets=num_presets)
    want, want_hist = jax_shard.sharded_lfg_encode(
        jax_shard.make_mesh(2), **kw)(pixels, presets)
    got, got_hist = shard.sharded_lfg_encode(["cpu", "cpu"], **kw)(
        pixels, presets)
    np.testing.assert_array_equal(got_hist.numpy(), np.asarray(want_hist))
    assert int(got_hist.sum()) > 0
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        w = np.asarray(v)
        g = got[k].numpy()
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(w.dtype), w, err_msg=k)


def test_sharded_lfg_encode_needs_an_even_split():
    fn = shard.sharded_lfg_encode(["cpu"] * 2, lfg_dim=256,
                                  linear_light=False, num_presets=1)
    with pytest.raises(ValueError, match="evenly"):
        fn(np.zeros((3, 256, 256, 3), np.uint8), np.zeros(3, np.int32))


@pytest.fixture(scope="module")
def jax_dryrun_8():
    """(printed line, symbols, section bytes) of the JAX package's
    __graft_entry__.dryrun_multichip(8) on the conftest's eight virtual
    CPU devices."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        __graft_entry__.dryrun_multichip(8)
    line = out.getvalue().strip()
    m = re.fullmatch(r"dryrun_multichip\(8\): ok, (\d+) symbols walked, "
                     r"(\d+) ANS section bytes", line)
    assert m, line
    return line, int(m.group(1)), int(m.group(2))


def test_dryrun_multichip_equals_jax(jax_front, jax_dryrun_8, capsys):
    """n = 8 over eight CPU entries, front patched: the line, symbols and
    section bytes of JAX's dry run on the same inputs."""
    line, syms, nbytes = jax_dryrun_8
    got = dryrun.dryrun_multichip(8, ["cpu"] * 8)
    assert got == (syms, nbytes)
    assert capsys.readouterr().out.strip() == line


def test_dryrun_multichip_with_the_ports_front(jax_dryrun_8):
    """Unpatched, the port's float front may flip a few quantizations
    (bounded at 1e-4 elsewhere); the symbol count stays within 1e-4 of
    JAX's."""
    _, want, _ = jax_dryrun_8
    syms, nbytes = dryrun.dryrun_multichip(8, ["cpu"] * 8)
    assert abs(syms - want) <= 1e-4 * want
    assert nbytes > 0


def test_dryrun_needs_one_device_per_lf_group():
    with pytest.raises(ValueError, match="devices for"):
        dryrun.dryrun_multichip(4, ["cpu"] * 3)


def test_entry_equals_jax_entry(jax_front):
    """The single-LF-group example, front patched: payload words equal
    the JAX package's __graft_entry__.entry()."""
    jfn, jargs = __graft_entry__.entry()
    want = np.asarray(jfn(*jargs)["combined"])
    fn, args = dryrun.entry("cpu")
    got = fn(*args).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
