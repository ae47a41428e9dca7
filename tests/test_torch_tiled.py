"""Tiled mode of the port (tile_size_shift >= 0: send_tile and
send_tile_batch) on the CPU, against the JAX package's tiled mode.

As in test_torch_e2e, whole files are compared with the port's front
replaced by the JAX package's integers (one float flip changes a file);
unpatched, libjxl decodes the port's tiled output, with the fused front,
at PSNR >= JAX tiled - 0.05 dB.  The port's own batched and per-tile
paths run the same front, so their bytes are compared unpatched.
"""

import numpy as np
import pytest

import hydrium_tpu_torch
from hydrium_tpu import encode_image as jax_encode_image
from hydrium_tpu.utils import djxl
from hydrium_tpu_torch import EncodeStats, ImageMetadata, SampleFormat
from hydrium_tpu_torch.ops import packed as TP
from test_e2e import make_image
# importing test_torch_e2e builds the JAX package's native plane under
# its lock (jax_native_ready)
from test_torch_e2e import (_forced_ok, jax_front,  # noqa: F401 (fixtures)
                            warm_state)


def _tiles(img, th, tw, rows=None):
    h, w = img.shape[:2]
    rows = range((h + th - 1) // th) if rows is None else rows
    return [(img[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw], tx, ty)
            for ty in rows for tx in range((w + tw - 1) // tw)]


def _encoder(h, w, shift=0, **kw):
    meta = ImageMetadata(width=w, height=h, tile_size_shift_x=shift,
                         tile_size_shift_y=shift)
    return hydrium_tpu_torch.Encoder(meta, device="cpu", **kw)


def _per_tile(img, shift=0, fmts=None):
    """The port's one-tile-at-a-time bytes (send_tile)."""
    h, w = img.shape[:2]
    enc = _encoder(h, w, shift)
    th = tw = 256 << shift
    for px, tx, ty in _tiles(img, th, tw):
        fmt = SampleFormat.UINT8 if fmts is None else fmts[ty]
        enc.send_tile(px if fmt == SampleFormat.UINT8
                      else (px / 255.0).astype(np.float32),
                      tx, ty, sample_fmt=fmt)
    return enc.take_output()


@pytest.mark.parametrize("h,w,shift", [(300, 700, 0), (512, 2400, 0),
                                       (300, 700, 1), (512, 2400, 1),
                                       (600, 530, 1)])
def test_bytes_equal_jax_tiled_with_jax_front(jax_front, h, w, shift):
    img = make_image(h, w, "noise", seed=h + w + shift)
    want = jax_encode_image(img, shift, backend="jax")
    stats = EncodeStats()
    got = hydrium_tpu_torch.encode_image(img, shift, device="cpu",
                                         stats=stats)
    assert got == want
    assert stats.counters.get("lfg_fallback", 0) == 0


def test_tile_batch_equals_per_tile():
    img = make_image(300, 700, "noise", seed=15)
    enc = _encoder(300, 700)
    enc.send_tile_batch(_tiles(img, 256, 256))
    assert enc.take_output() == _per_tile(img)


def test_tile_batch_multi_chunk_equals_per_tile(monkeypatch):
    """20 tiles in one call: two stacked chunks (9 full tiles each, cut
    by the edge tile that ends each row) and two edge tiles, so four
    dispatches carry twenty tiles."""
    img = make_image(512, 2400, "gradient", seed=16)
    real = TP.pack_payload
    dispatches = []

    def counted(out, *a, **k):
        dispatches.append(out["valid_len"].shape[0] // 3072)
        return real(out, *a, **k)

    monkeypatch.setattr(TP, "pack_payload", counted)
    enc = _encoder(512, 2400)
    enc.send_tile_batch(_tiles(img, 256, 256))
    batched = enc.take_output()
    assert sorted(dispatches) == [1, 1, 16, 16]     # groups per dispatch
    assert enc.stats.counters["lfg_packed"] == 4
    monkeypatch.setattr(TP, "pack_payload", real)
    assert batched == _per_tile(img)


def test_run_persists_across_calls_into_one_chunk(monkeypatch):
    """Row-at-a-time sends (as the bench and the CLI send) fill one
    stacked chunk across calls: 3 rows of 4 full tiles, 1 dispatch."""
    img = make_image(768, 1024, "noise", seed=17)
    calls = []
    real = TP.pack_payload
    monkeypatch.setattr(TP, "pack_payload",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    enc = _encoder(768, 1024)
    out = bytearray()
    for ty in range(3):
        enc.send_tile_batch(_tiles(img, 256, 256, rows=[ty]))
        out.extend(enc.take_output())
    assert len(calls) == 1
    assert enc.stats.counters["lfg_packed"] == 1
    monkeypatch.setattr(TP, "pack_payload", real)
    assert bytes(out) == _per_tile(img)


def test_failed_chunk_reencodes_under_its_own_format(monkeypatch):
    """A chunk whose payload reports ok = 0 drains after the next call
    switched the sample format: its tiles still re-encode as u8."""
    img = make_image(512, 1024, "noise", seed=18)
    fmts = [SampleFormat.UINT8, SampleFormat.FLOAT32]
    want = _per_tile(img, fmts=fmts)
    _forced_ok(monkeypatch, 0)
    enc = _encoder(512, 1024)
    enc.send_tile_batch(_tiles(img, 256, 256, rows=[0]))
    row1 = [((px / 255.0).astype(np.float32), tx, ty)
            for px, tx, ty in _tiles(img, 256, 256, rows=[1])]
    enc.send_tile_batch(row1, sample_fmt=SampleFormat.FLOAT32)
    got = enc.take_output()
    c = enc.stats.counters
    assert c["lfg_fallback"] == 1           # the u8 chunk
    assert c["lfg_packed"] == 4 + 1         # its tiles, then the f32 chunk
    assert got == want


def test_fused_front_decodes_at_jax_tiled_psnr():
    img = make_image(300, 700, "noise", seed=19)
    mine = hydrium_tpu_torch.encode_image(img, 0, device="cpu",
                                          fused_front=True)
    ref = jax_encode_image(img, 0, backend="jax")
    dec = djxl.decode(mine)
    assert dec.shape == img.shape
    p = djxl.psnr(img / 255.0, dec)
    p_jax = djxl.psnr(img / 255.0, djxl.decode(ref))
    assert p >= p_jax - 0.05, (p, p_jax)


def test_tile_out_of_bounds_raises():
    enc = _encoder(300, 700)
    with pytest.raises(ValueError):
        enc.send_tile_batch([(np.zeros((256, 256, 3), np.uint8), 3, 0)])
