"""The port's API contract on the CPU: twins of the cases of
tests/test_api_contract.py that need no reference encoder.  Error
discipline as the reference's (libhydrium.c:46-203), BufferedEncoder's
caller-owned buffers, and tiled-mode ordering."""

import numpy as np
import pytest

import hydrium_tpu_torch as H
from hydrium_tpu.utils import djxl
from hydrium_tpu_torch import (NEED_MORE_OUTPUT, OK, BufferedEncoder, Encoder,
                               ImageMetadata, SampleFormat)
from test_torch_e2e import warm_state  # noqa: F401 (autouse fixture)


def _enc(w, h, shift=-1, **kw):
    return Encoder(ImageMetadata(width=w, height=h, tile_size_shift_x=shift,
                                 tile_size_shift_y=shift), device="cpu", **kw)


def test_exports_cover_the_jax_packages():
    import hydrium_tpu

    assert set(hydrium_tpu.__all__) <= set(H.__all__)
    for name in hydrium_tpu.__all__:
        assert hasattr(H, name), name
    assert H.HYD_UINT8 is SampleFormat.UINT8
    assert H.HYD_UINT16 is SampleFormat.UINT16
    assert H.HYD_FLOAT32 is SampleFormat.FLOAT32
    assert (OK, NEED_MORE_OUTPUT) == (hydrium_tpu.OK,
                                      hydrium_tpu.NEED_MORE_OUTPUT)


@pytest.mark.parametrize("kw", [
    dict(width=0, height=10), dict(width=(1 << 30) + 1, height=10),
    dict(width=1 << 30, height=1 << 30),            # > 2^40 pixels
    dict(width=10, height=10, tile_size_shift_x=4),
    dict(width=10, height=10, tile_size_shift_y=-2)])
def test_metadata_validation(kw):
    with pytest.raises(ValueError):
        ImageMetadata(**kw).validate()
    with pytest.raises(ValueError):
        Encoder(ImageMetadata(**kw), device="cpu")
    ImageMetadata(width=1 << 20, height=1 << 20).validate()


def test_tile_out_of_bounds():
    with pytest.raises(ValueError):
        _enc(100, 100).send_tile(np.zeros((100, 100, 3), np.uint8), 1, 0)
    with pytest.raises(ValueError):
        _enc(100, 100, 0).send_tile(np.zeros((100, 100, 3), np.uint8), 0, 1)


def test_duplicate_tile_rejected():
    enc = _enc(4000, 100)
    enc.send_tile(np.zeros((100, 2048, 3), np.uint8), 0, 0)
    with pytest.raises(ValueError):
        enc.send_tile(np.zeros((100, 2048, 3), np.uint8), 0, 0)


@pytest.mark.parametrize("shift", [-1, 0])
def test_send_after_last_rejected(shift):
    enc = _enc(100, 100, shift)
    enc.send_tile(np.zeros((100, 100, 3), np.uint8), 0, 0)
    assert enc.finished
    with pytest.raises(RuntimeError):
        enc.send_tile(np.zeros((100, 100, 3), np.uint8), 0, 0)
    with pytest.raises(RuntimeError):
        enc.send_tile_batch([(np.zeros((100, 100, 3), np.uint8), 0, 0)])


def test_unsent_tiles_zero_filled():
    """Any tile except the last may be left unsent (libhydrium.h:240)."""
    enc = _enc(4000, 100)
    enc.send_tile(np.full((100, 4000 - 2048, 3), 200, np.uint8), 1, 0,
                  is_last=1)                 # only the last tile
    dec = djxl.decode(enc.take_output())
    assert dec.shape == (100, 4000, 3)
    assert dec[:, 2048:2100].mean() > dec[:, :100].mean() + 0.3


def test_out_of_order_tiles_decode():
    img = np.random.default_rng(0).integers(0, 255, (200, 4000, 3),
                                            dtype=np.uint8)
    enc = _enc(4000, 200)
    enc.send_tile(img[:, 2048:], 1, 0, is_last=0)
    assert not enc.finished
    enc.send_tile(img[:, :2048], 0, 0, is_last=1)
    dec = djxl.decode(enc.take_output())
    assert dec.shape == img.shape
    assert djxl.psnr(img / 255.0, dec) > 15


def test_asymmetric_tile_shifts():
    img = np.random.default_rng(1).integers(0, 255, (600, 700, 3),
                                            dtype=np.uint8)
    meta = ImageMetadata(width=700, height=600, tile_size_shift_x=1,
                         tile_size_shift_y=0)
    enc = Encoder(meta, device="cpu")
    th, tw = meta.tile_height, meta.tile_width
    for ty in range((600 + th - 1) // th):
        for tx in range((700 + tw - 1) // tw):
            enc.send_tile(img[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw],
                          tx, ty)
    assert djxl.decode(enc.take_output()).shape == img.shape


def _pump(be, buf, got, st, on_swap=None):
    """The reference's swap-and-recall loop; returns the swaps made."""
    swaps = 0
    while st == NEED_MORE_OUTPUT:
        swaps += 1
        if on_swap is not None:
            on_swap()
        n = be.release_output_buffer()
        assert n == len(buf)        # suspended exactly on a full buffer
        got.extend(buf[:n])
        be.provide_output_buffer(buf)
        st = be.pump()
    assert st == OK
    return swaps


def test_buffered_encoder_push_model():
    """Same bytes as the pull model, delivered only through a small
    caller-owned buffer, suspending whenever it fills."""
    img = np.random.default_rng(8).integers(0, 255, (300, 520, 3),
                                            dtype=np.uint8)
    want = H.encode_image(img, device="cpu")
    be = BufferedEncoder(_enc(520, 300))
    buf = bytearray(4096)       # far smaller than the output
    got = bytearray()
    be.provide_output_buffer(buf)
    swaps = _pump(be, buf, got, be.send_tile(img, 0, 0))
    got.extend(buf[:be.release_output_buffer()])
    assert swaps >= 2
    assert be.finished
    assert bytes(got) == want


def test_buffered_encoder_contract_errors():
    be = BufferedEncoder(_enc(64, 64))
    with pytest.raises(RuntimeError):
        be.release_output_buffer()
    be.provide_output_buffer(bytearray(64))
    with pytest.raises(RuntimeError):
        be.provide_output_buffer(bytearray(64))     # double provide
    be.release_output_buffer()
    with pytest.raises(RuntimeError):
        be.pump()                                   # no buffer
    for small in (0, 63):                           # the 64-byte minimum
        with pytest.raises(ValueError):
            be.provide_output_buffer(bytearray(small))
    with pytest.raises(ValueError):
        be.provide_output_buffer(bytes(64))         # read-only
    assert not be.finished


def test_buffered_encoder_tiny_buffer_multi_lfg():
    """A 65-byte caller buffer through a multi-LF-group streaming
    encode: thousands of suspend/swap cycles deliver exactly the
    pull-model bytes, and the adapter's backlog follows the caller's
    buffer size, not iter_output's 4 MB default."""
    w, h = 2600, 300
    img = np.random.default_rng(11).integers(0, 255, (h, w, 3),
                                             dtype=np.uint8)
    ref = _enc(w, h, streaming=True)
    ref.send_tile(img[:, :2048], 0, 0)
    ref.send_tile(img[:, 2048:], 1, 0)
    want = ref.take_output()

    be = BufferedEncoder(_enc(w, h, streaming=True))
    buf = bytearray(65)
    got = bytearray()
    backlog = []
    note = lambda: backlog.append(sum(len(c) - off for c, off in be._chunks))
    be.provide_output_buffer(buf)
    swaps = _pump(be, buf, got, be.send_tile(img[:, :2048], 0, 0), note)
    swaps += _pump(be, buf, got, be.send_tile(img[:, 2048:], 1, 0), note)
    got.extend(buf[:be.release_output_buffer()])
    assert be.finished
    assert bytes(got) == want
    assert swaps > 1000             # suspended mid-everything
    assert max(backlog) < 1 << 17   # never a 4 MB chunk


def _tiles(img, th=256, tw=256):
    return [(img[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw], tx, ty)
            for ty in range((img.shape[0] + th - 1) // th)
            for tx in range((img.shape[1] + tw - 1) // tw)]


@pytest.mark.parametrize("sends", ["rows", "interleaved"])
def test_tiled_batch_deferred_ordering_parity(sends):
    """send_tile_batch keeps units in flight across calls, fetches them
    on their own threads and renders frames on a pool; the bytes still
    equal the strictly sequential send_tile path."""
    img = np.random.default_rng(7).integers(0, 255, (520, 1230, 3),
                                            dtype=np.uint8)
    tiles = _tiles(img)
    ref = _enc(1230, 520, 0)
    want = bytearray()
    for px, tx, ty in tiles:
        ref.send_tile(px, tx, ty)
        want.extend(ref.take_output())

    enc = _enc(1230, 520, 0)
    got = bytearray()
    if sends == "rows":
        for ty in range(3):
            enc.send_tile_batch([t for t in tiles if t[2] == ty])
            got.extend(enc.take_output())
    else:
        # a single send_tile between batch calls flushes the units in
        # flight; the split falls mid-row
        enc.send_tile_batch(tiles[:3])
        enc.send_tile(*tiles[3])
        enc.send_tile_batch(tiles[4:])
        got.extend(enc.take_output())
    assert enc.finished
    assert bytes(got) == bytes(want)
    if sends == "rows":
        assert djxl.decode(bytes(got)).shape == img.shape


def test_tiled_batch_rejects_tiles_after_last():
    img = np.random.default_rng(8).integers(0, 255, (256, 512, 3),
                                            dtype=np.uint8)
    enc = _enc(512, 256, 0)
    # the bottom-right (last) tile first, then another in one batch
    with pytest.raises(RuntimeError):
        enc.send_tile_batch([(img[:, 256:512], 1, 0), (img[:, :256], 0, 0)])


def test_tiled_batch_pending_run_format_change():
    """A run held across calls flushes under its own sample format when
    the next call switches formats; the per-tile path with the same
    per-tile formats is the oracle."""
    img8 = np.random.default_rng(13).integers(0, 256, (512, 512, 3)).astype(
        np.uint8)
    img16 = img8.astype(np.uint16) * 257
    rows = [([(img16[:256, tx * 256:(tx + 1) * 256], tx, 0)
              for tx in range(2)], SampleFormat.UINT16),
            ([(img8[256:, tx * 256:(tx + 1) * 256], tx, 1)
              for tx in range(2)], SampleFormat.UINT8)]
    ref = _enc(512, 512, 0)
    for entries, fmt in rows:
        for px, tx, ty in entries:
            ref.send_tile(px, tx, ty, sample_fmt=fmt)
    enc = _enc(512, 512, 0)
    for entries, fmt in rows:
        enc.send_tile_batch(entries, sample_fmt=fmt)
    assert enc.take_output() == ref.take_output()
    assert enc.stats.counters["lfg_packed"] == 2    # one chunk per format


@pytest.mark.parametrize("shift", [-1, 0])
def test_positional_backend_gives_the_jax_packages_bytes(shift):
    """encode_image's positional order is the JAX package's: image,
    tile_size_shift, linear_light, sample_fmt, backend."""
    import hydrium_tpu

    img = np.random.default_rng(14).integers(0, 256, (200, 300, 3),
                                             dtype=np.uint8)
    want = hydrium_tpu.encode_image(img, shift, False, None, "numpy")
    assert H.encode_image(img, shift, False, None, "numpy") == want


def test_positional_encoder_backend_and_keyword_only_device():
    """Encoder(meta, "numpy") is the numpy plane in both packages; a
    device in backend's place is an unknown backend, and device cannot
    be passed by position."""
    import hydrium_tpu

    img = np.random.default_rng(15).integers(0, 256, (200, 300, 3),
                                             dtype=np.uint8)
    outs = []
    for pkg in (hydrium_tpu, H):
        enc = pkg.Encoder(pkg.ImageMetadata(width=300, height=200), "numpy")
        enc.send_tile(img, 0, 0)
        outs.append(enc.take_output())
    assert outs[0] == outs[1] and outs[0][:2] == b"\xff\x0a"
    meta = ImageMetadata(width=300, height=200)
    with pytest.raises(ValueError, match="unknown backend 'cpu'"):
        Encoder(meta, "cpu")
    with pytest.raises(TypeError):
        Encoder(meta, "torch", None, None, None, "cpu")
    with pytest.raises(TypeError):
        H.encode_image(img, -1, False, None, "torch", "cpu")
