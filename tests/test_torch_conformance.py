"""Whole files of the port's conformance profile (the numpy plane:
Encoder(backend="numpy") / profile="conformance") against the JAX
package's backend="numpy", byte for byte.  Both sides run the same
numpy arithmetic, so nothing is patched; the default device stays
"cuda", which the numpy plane ignores, so these run without a card."""

import hashlib

import numpy as np
import pytest
import torch

import hydrium_tpu as J
import hydrium_tpu_torch as H
from chip_smoke import CONFORMANCE_SHA256, conformance_inputs
from hydrium_tpu import encoder as JE
from hydrium_tpu import models as jax_models
from hydrium_tpu.jxl import native as jax_native
from hydrium_tpu_torch import encoder as TE
from hydrium_tpu_torch import models
from hydrium_tpu_torch.jxl import native as torch_native
from test_e2e import make_image
from test_torch_e2e import warm_state  # noqa: F401 (autouse fixture)
from test_torch_formats import _minimal_icc

def _image(h, w, kind="noise", seed=0):
    if kind == "flat":
        return np.full((h, w, 3), 117, np.uint8)
    return make_image(h, w, kind, seed=seed)


def _meta(pkg, img, shift=-1, linear=False):
    h, w = img.shape[:2]
    return pkg.ImageMetadata(width=w, height=h, linear_light=linear,
                             tile_size_shift_x=shift,
                             tile_size_shift_y=shift)


def _tiles(img, meta):
    """(pixels, tx, ty) in raster order: 2048^2 LF groups one-frame,
    the metadata's tiles in tiled mode."""
    h, w = img.shape[:2]
    tw, th = ((2048, 2048) if meta.one_frame
              else (meta.tile_width, meta.tile_height))
    return [(img[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw], tx, ty)
            for ty in range(-(-h // th)) for tx in range(-(-w // tw))]


def _feed(enc, entries, last_explicit=False):
    """Send u8 entries one at a time; is_last only on the final one when
    last_explicit (tiles out of order); returns the output bytes."""
    out = bytearray()
    for i, (px, tx, ty) in enumerate(entries):
        is_last = int(i == len(entries) - 1) if last_explicit else -1
        enc.send_tile(px, tx, ty, is_last)
        out.extend(enc.take_output())
    assert enc.finished
    return bytes(out)


def _both(img, shift=-1, **kw):
    got = H.encode_image(img, shift, profile="conformance", **kw)
    want = J.encode_image(img, shift, backend="numpy", **kw)
    return got, want


@pytest.mark.parametrize("h,w", [(1, 1), (8, 8), (33, 17), (256, 256),
                                 (300, 520), (300, 2100)])
def test_one_frame_sizes(h, w):
    """1x1, 8x8 and 256^2 are single-group frames (a 1-entry TOC);
    300x2100 is two LF groups."""
    got, want = _both(_image(h, w, seed=h + w))
    assert got[:2] == b"\xff\x0a"
    assert got == want


@pytest.mark.parametrize("shift", [-1, 1])
@pytest.mark.parametrize("kind", ["noise", "smooth", "flat"])
def test_content(kind, shift):
    got, want = _both(_image(300, 520, kind, seed=3), shift)
    assert got == want


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_tiled_shifts(shift):
    got, want = _both(_image(700, 600, "smooth", seed=4), shift)
    assert got == want


def _format_image(name):
    img = _image(200, 300, "smooth", seed=5)
    if name == "u16":
        rng = np.random.default_rng(5)
        return img.astype(np.uint16) * 257 + rng.integers(
            0, 257, img.shape).astype(np.uint16), False
    if name == "u8_linear":
        return img, True
    f32 = img.astype(np.float32) / np.float32(255)
    return f32, name == "f32_linear"


@pytest.mark.parametrize("shift", [-1, 0])
@pytest.mark.parametrize("name", ["u16", "f32", "f32_linear", "u8_linear"])
def test_formats(name, shift):
    img, linear = _format_image(name)
    got, want = _both(img, shift, linear_light=linear)
    assert got == want


@pytest.mark.parametrize("streaming", [True, False])
def test_streaming_choice_on_two_lf_groups(tmp_path, streaming):
    img = _image(160, 2100, seed=6)
    spool = str(tmp_path) if streaming else None
    outs = []
    for pkg in (H, J):
        enc = pkg.Encoder(_meta(pkg, img), backend="numpy",
                          streaming=streaming, spool_dir=spool)
        assert enc.streaming is streaming
        outs.append(_feed(enc, _tiles(img, enc.metadata)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("threshold,streams", [(2, True), (17, False)])
def test_streaming_threshold_rule(monkeypatch, threshold, streams):
    """Left to itself the numpy plane streams a one-frame encode from
    STREAMING_LFG_THRESHOLD LF groups up (two here)."""
    monkeypatch.setattr(TE.Encoder, "STREAMING_LFG_THRESHOLD", threshold)
    monkeypatch.setattr(JE.Encoder, "STREAMING_LFG_THRESHOLD", threshold)
    img = _image(160, 2100, "smooth", seed=7)
    outs = []
    for pkg in (H, J):
        enc = pkg.Encoder(_meta(pkg, img), backend="numpy")
        assert enc.streaming is streams
        outs.append(_feed(enc, _tiles(img, enc.metadata)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("shape,shift", [((160, 2100), -1),
                                         ((700, 600), 0)])
def test_tiles_out_of_order(shape, shift):
    img = _image(*shape, "smooth", seed=8)
    outs = []
    for pkg in (H, J):
        enc = pkg.Encoder(_meta(pkg, img, shift), backend="numpy")
        entries = _tiles(img, enc.metadata)[::-1]
        outs.append(_feed(enc, entries, last_explicit=True))
    assert outs[0] == outs[1]
    assert outs[0] != J.encode_image(img, shift, backend="numpy")


@pytest.mark.parametrize("shift", [-1, 0])
@pytest.mark.parametrize("layout", ["planar", "strided"])
def test_planar_and_strided_input(layout, shift):
    img = _image(300, 520, seed=9)
    want = J.encode_image(img, shift, backend="numpy")
    enc = H.Encoder(_meta(H, img, shift), profile="conformance")
    if layout == "planar":
        entries = [((px[..., 0], px[..., 1], px[..., 2]), tx, ty)
                   for px, tx, ty in _tiles(img, enc.metadata)]
    else:
        big = np.zeros((2 * 300 + 1, 3 * 520, 3), np.uint8)
        big[1::2, ::3] = img
        view = big[1::2, ::3]
        assert not view.flags.c_contiguous
        entries = _tiles(view, enc.metadata)
    assert _feed(enc, entries) == want


@pytest.mark.parametrize("shift", [0, 1])
def test_send_tile_batch_equals_per_tile_sends(shift):
    img = _image(700, 600, "smooth", seed=10)
    want = J.encode_image(img, shift, backend="numpy")
    enc = H.Encoder(_meta(H, img, shift), backend="numpy")
    entries = _tiles(img, enc.metadata)
    per_tile = _feed(enc, entries)
    enc = H.Encoder(_meta(H, img, shift), backend="numpy")
    out = bytearray()
    row = -(-img.shape[1] // enc.metadata.tile_width)
    for i in range(0, len(entries), row):
        enc.send_tile_batch(entries[i:i + row])
        out.extend(enc.take_output())
    assert enc.finished
    assert bytes(out) == per_tile == want


@pytest.mark.parametrize("streaming", [None, True])
def test_buffered_encoder_tiny_buffer_two_lf_groups(tmp_path, streaming):
    img = _image(64, 2100, "smooth", seed=11)
    jenc = J.Encoder(_meta(J, img), backend="numpy", streaming=streaming)
    want = _feed(jenc, _tiles(img, jenc.metadata))
    be = H.BufferedEncoder(H.Encoder(
        _meta(H, img), backend="numpy", streaming=streaming,
        spool_dir=str(tmp_path)))
    buf = bytearray(64)
    pushed = bytearray()
    be.provide_output_buffer(buf)
    swaps = 0
    for px, tx, ty in _tiles(img, be.encoder.metadata):
        st = be.send_tile(px, tx, ty)
        while st == H.NEED_MORE_OUTPUT:
            swaps += 1
            pushed.extend(buf[:be.release_output_buffer()])
            be.provide_output_buffer(buf)
            st = be.pump()
    pushed.extend(buf[:be.release_output_buffer()])
    assert be.finished and swaps > 500
    assert bytes(pushed) == want


@pytest.mark.parametrize("w", [520, 2100])
def test_icc_tagging_one_frame(w):
    img = _image(160, w, seed=12)
    icc = _minimal_icc()
    outs = []
    for pkg in (H, J):
        enc = pkg.Encoder(_meta(pkg, img), backend="numpy")
        enc.set_suggested_icc_profile(icc)
        outs.append(_feed(enc, _tiles(img, enc.metadata)))
    assert outs[0] == outs[1]
    assert outs[0] != J.encode_image(img, backend="numpy")


@pytest.mark.parametrize("shift", [-1, 0])
def test_without_the_native_plane(monkeypatch, shift):
    """Both packages' native plane reported unavailable: the pure-Python
    bit writer, HF stream and ANS encoder."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(torch_native, "available", lambda: False)
    img = _image(160, 300, seed=13)
    enc = H.Encoder(_meta(H, img, shift), backend="numpy")
    assert not enc.streaming
    got = _feed(enc, _tiles(img, enc.metadata))
    assert got == J.encode_image(img, shift, backend="numpy")


def test_without_cuda(monkeypatch):
    """No card: the conformance encode runs, the device plane on "cuda"
    still raises (no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _image(300, 520, seed=14)
    got = H.encode_image(img, device="cuda", profile="conformance")
    assert got == J.encode_image(img, backend="numpy")
    for kw in ({"profile": "fast"}, {"backend": "torch"}, {}):
        with pytest.raises(RuntimeError, match="CUDA"):
            H.Encoder(_meta(H, img), device="cuda", **kw)


@pytest.mark.parametrize("name", sorted(CONFORMANCE_SHA256))
def test_chip_smoke_digests(name):
    """The digests chip_smoke.py's phase 9 holds the card machine's
    files to are hydrium_tpu's backend="numpy" files."""
    (_, px, shift, linear), = [c for c in conformance_inputs()
                               if c[0] == name]
    want = J.encode_image(px, shift, linear_light=linear, backend="numpy")
    assert hashlib.sha256(want).hexdigest() == CONFORMANCE_SHA256[name]
    got = H.encode_image(px, shift, linear_light=linear,
                         profile="conformance")
    assert got == want


@pytest.mark.parametrize("kw", [{"backend": "jax"}, {"backend": "cuda"},
                                {"profile": "turbo"},
                                {"profile": jax_models.FAST}])
def test_unknown_backend_or_profile_raises(kw):
    img = _image(8, 8)
    with pytest.raises(ValueError) as exc:
        H.Encoder(_meta(H, img), **kw)
    if kw.get("profile") == "turbo":
        with pytest.raises(ValueError) as want:
            J.Encoder(_meta(J, img), **kw)
        assert str(exc.value) == str(want.value)
    else:
        assert "'torch'" in str(exc.value) and "'numpy'" in str(exc.value)


@pytest.mark.parametrize("shift", [-1, 0])
def test_numpy_plane_builds_nothing_of_the_device_plane(monkeypatch,
                                                        tmp_path, shift):
    """No device, transport codec, front, worker thread or warm-state
    file: each would raise here.  A Profile object and a profile that
    overrides backend= are taken as the JAX package takes them."""
    def refuse(*a, **k):
        raise AssertionError("the numpy plane touched the device plane")

    monkeypatch.setattr(TE, "_shared_codec", refuse)
    monkeypatch.setattr(TE, "resolve_device", refuse)
    monkeypatch.setattr(TE, "ThreadPoolExecutor", refuse)
    monkeypatch.setattr(TE, "_save_warm_state", refuse)
    monkeypatch.setattr(TE._front.FrontEnd, "from_tables", refuse)
    img = _image(160, 2100, "smooth", seed=15)
    want = J.encode_image(img, shift, backend="numpy")
    for kw in ({"profile": models.CONFORMANCE},
               {"backend": "torch", "profile": "conformance"}):
        enc = H.Encoder(_meta(H, img, shift), **kw)
        assert enc.backend == "numpy" and enc.device is None
        assert _feed(enc, _tiles(img, enc.metadata)) == want
    assert not (tmp_path / "warm").exists()
